"""Gamma/beta/erf families, composition helpers, float utilities.

Counterpart of ``russell_tpu.math.basic`` (reference surface:
russell_lab/src/math/{gamma,ln_gamma,beta,erf,erf_inv,functions,
composition,modulo,complex}.rs). The tensor functions follow the device
rule of ``core/_place.py``: a tensor argument's device, else ``device=``
(the card by default). ``factorial_lookup_22``, the float helpers and the
complex helpers are host Python scalars, as in the reference.

``gamma`` is the reference's ``sign(Gamma) exp(lgamma)`` (torch has no
gamma), NaN at the poles; ``ln_beta`` and ``beta`` carry their own copy
of the algorithm the reference reaches through ``jax.scipy.special``
(scipy's cdflib ``betaln`` with ``algdiv`` for b >= 8), which keeps the
digits that ``lgamma(a) + lgamma(b) - lgamma(a + b)`` loses for large
arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.core._place import div, f64, on, place

__all__ = [
    "gamma", "ln_gamma", "beta", "ln_beta", "factorial_lookup_22",
    "erf", "erfc", "erf_inv", "erfc_inv",
    "neg_one_pow_n", "sign", "ramp", "heaviside", "boxcar", "logistic",
    "logistic_deriv1", "smooth_ramp", "smooth_ramp_deriv1",
    "smooth_ramp_deriv2", "suq_sin", "suq_cos",
    "float_is_integer", "float_is_neg_integer", "float_split",
    "float_decompose", "float_compose", "modulo",
    "i_pow_n", "x_times_i_pow_n",
]


# -- gamma family (gamma.rs, ln_gamma.rs, beta.rs) ---------------------------

def _gammasgn(x):
    """The sign of Gamma(x): NaN at the poles (and for NaN), -1 where
    Gamma is negative (and at -0), 1 elsewhere."""
    floor_x = torch.floor(x)
    neg = x < 0
    nan = (neg & (x == floor_x)) | torch.isnan(x)
    minus = (neg & (torch.remainder(floor_x, 2.0) != 0)) | (
        (x == 0) & torch.signbit(x))
    return torch.where(nan, math.nan,
                       torch.where(minus, -1.0, 1.0).to(x.dtype))


def gamma(x, device=None):
    """Gamma(x) with poles at non-positive integers (gamma.rs)."""
    x = f64(x, device)
    out = _gammasgn(x) * torch.exp(torch.lgamma(x))
    neg_int = (x <= 0.0) & (x == torch.floor(x))
    return torch.where(neg_int, math.nan, out)


def ln_gamma(x, device=None):
    """ln|Gamma(x)| (ln_gamma.rs; LAPACK-free)."""
    return torch.lgamma(f64(x, device))


# algdiv's series coefficients (scipy cdflib algdiv.f)
_ALGDIV_C = (0.833333333333333e-01, -0.277777777760991e-02,
             0.793650666825390e-03, -0.595202931351870e-03,
             0.837308034031215e-03, -0.165322962780713e-02)


def _algdiv(a, b):
    """ln(Gamma(b) / Gamma(a + b)) for b >= 8, assuming a <= b (scipy
    cdflib algdiv.f, in the operation order of the copy in jax's
    ``third_party/scipy/betaln.py``)."""
    c0, c1, c2, c3, c4, c5 = _ALGDIV_C
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = div(1.0, b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
         + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def _betaln(a, b):
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


def beta(a, b, device=None):
    """B(a, b) (beta.rs): sign(Gamma(a) Gamma(b) / Gamma(a + b)) times
    exp(ln_beta)."""
    a, b = torch.broadcast_tensors(*on(a, b, device=device,
                                       dtype=torch.float64))
    sgn = _gammasgn(a) * _gammasgn(b) * _gammasgn(a + b)
    return sgn * torch.exp(_betaln(a, b))


def ln_beta(a, b, device=None):
    """ln|B(a, b)| (beta.rs)."""
    a, b = torch.broadcast_tensors(*on(a, b, device=device,
                                       dtype=torch.float64))
    return _betaln(a, b)


_FACT22 = np.array([math.factorial(n) for n in range(23)], dtype=np.float64)


def factorial_lookup_22(n: int) -> float:
    """n! for n <= 22, exact in f64 (functions.rs: factorial_lookup_22).
    A host Python float, as in the reference."""
    if n < 0 or n > 22:
        raise ValueError("n must be in 0..=22")
    return float(_FACT22[n])


# -- erf family (erf.rs, erf_inv.rs) -----------------------------------------

def erf(x, device=None):
    return torch.special.erf(f64(x, device))


def erfc(x, device=None):
    return torch.special.erfc(f64(x, device))


def erf_inv(x, device=None):
    """Inverse error function; +-inf at +-1, NaN outside (erf_inv.rs)."""
    x = f64(x, device)
    out = torch.special.erfinv(x)
    out = torch.where(torch.abs(x) > 1.0, math.nan, out)
    return torch.where(torch.abs(x) == 1.0, torch.sign(x) * math.inf, out)


def erfc_inv(x, device=None):
    return erf_inv(1.0 - f64(x, device))


# -- composition functions (functions.rs) ------------------------------------

def neg_one_pow_n(n, device=None):
    """(-1)^n for integer n."""
    if not isinstance(n, torch.Tensor):
        n = torch.as_tensor(np.asarray(n), device=place(device=device))
    return torch.where(n % 2 == 0, 1.0, -1.0).to(torch.float64)


def sign(x, device=None):
    return torch.sign(f64(x, device))


def ramp(x, device=None):
    """max(x, 0) (Macaulay bracket)."""
    x = f64(x, device)
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def heaviside(x, device=None):
    """0 for x<0, 1/2 at 0, 1 for x>0."""
    x = f64(x, device)
    return torch.where(x < 0.0, 0.0, torch.where(x > 0.0, 1.0, 0.5)).to(
        torch.float64)


def boxcar(x, a, b, device=None):
    """heaviside(x-a) - heaviside(x-b)."""
    x = f64(x, place(x, a, b, device=device))
    return heaviside(x - a) - heaviside(x - b)


def logistic(x, device=None):
    return torch.special.expit(f64(x, device))


def logistic_deriv1(x, device=None):
    z = logistic(x, device)
    return z * (1.0 - z)


def smooth_ramp(x, beta, device=None):
    """Smooth approximation of ramp: x + ln(1+exp(-beta x))/beta."""
    x = f64(x, device)
    # overflow-safe (functions.rs guards -beta*x > 500)
    return torch.where(-beta * x > 500.0, 0.0,
                       x + div(torch.log1p(torch.exp(-beta * x)), beta))


def smooth_ramp_deriv1(x, beta, device=None):
    x = f64(x, device)
    return torch.where(-beta * x > 500.0, 0.0,
                       div(1.0, 1.0 + torch.exp(-beta * x)))


def smooth_ramp_deriv2(x, beta, device=None):
    x = f64(x, device)
    lim = 500.0 / beta
    e = torch.exp(-beta * torch.clamp(x, -lim, lim))
    out = div(beta * e, (1.0 + e) ** 2)
    return torch.where(-beta * x > 500.0, 0.0, out)


def suq_sin(x, q, device=None):
    """Superquadric sine: sign(sin x) |sin x|^q."""
    s = torch.sin(f64(x, device))
    return torch.sign(s) * torch.abs(s) ** q


def suq_cos(x, q, device=None):
    c = torch.cos(f64(x, device))
    return torch.sign(c) * torch.abs(c) ** q


# -- float helpers (composition.rs, modulo.rs): host Python scalars -----------

def float_is_integer(x) -> bool:
    x = float(x)
    return x == math.floor(x) and math.isfinite(x)


def float_is_neg_integer(x) -> bool:
    x = float(x)
    return x <= 0.0 and float_is_integer(x)


def float_split(x):
    """(integer_part, fractional_part) with the sign of x (modf)."""
    f, i = math.modf(float(x))
    return i, f


def float_decompose(x):
    """(mantissa, exponent) with x = mantissa * 2^exponent (frexp)."""
    return math.frexp(float(x))


def float_compose(mantissa, exponent):
    return math.ldexp(float(mantissa), int(exponent))


def modulo(x, y, device=None):
    """Floating-point modulo with the sign of x (Fortran MOD; modulo.rs)."""
    return torch.fmod(*on(x, y, device=device, dtype=torch.float64))


# -- complex helpers (complex.rs): host Python scalars ------------------------

def i_pow_n(n: int):
    """i^n."""
    return (1j) ** (int(n) % 4)


def x_times_i_pow_n(x, n: int):
    """x * i^n without complex rounding error."""
    r = int(n) % 4
    if r == 0:
        return complex(x, 0.0)
    if r == 1:
        return complex(0.0, x)
    if r == 2:
        return complex(-x, 0.0)
    return complex(0.0, -x)
