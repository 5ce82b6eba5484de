"""Bessel functions J0/J1/Jn, Y0/Y1/Yn, I0/I1/In, K0/K1/Kn.

Counterpart of ``russell_tpu.math.bessel`` (reference surface:
russell_lab/src/math/bessel_0.rs, bessel_1.rs, bessel_n.rs,
bessel_mod.rs). Every function follows the device rule of
``core/_place.py`` and computes elementwise in f64 torch ops: piecewise
branches are evaluated on both sides and combined with ``torch.where``,
the small-argument parts are Chebyshev expansions (the reference's tables,
``_coeffs.py``) evaluated by Clenshaw recurrence, the large-argument parts
the Hankel modulus/phase decomposition. I0/I1 are ``torch.special``'s (the
reference takes ``jax.scipy.special``'s). ``bessel_jn`` and ``bessel_in``
run Miller's backward recurrence with the reference's static trip counts
as eager ops: about 150 steps of about 10 elementwise launches at n 50.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.core._place import div, f64
from russell_tpu_torch.math import _coeffs as cf

__all__ = ["bessel_j0", "bessel_j1", "bessel_jn", "bessel_y0", "bessel_y1",
           "bessel_yn", "bessel_i0", "bessel_i1", "bessel_in", "bessel_k0",
           "bessel_k1", "bessel_kn"]

TWO_BY_PI = 2.0 / np.pi


def _clenshaw(coeffs: np.ndarray, t):
    """Evaluate sum_k c_k T_k(s) with s = 2t - 1 mapped from t in [0, 1]."""
    s = 2.0 * (2.0 * t - 1.0)  # 2*s for the recurrence
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in coeffs[:0:-1]:
        b1, b2 = s * b1 - b2 + float(c), b1
    return (s / 2.0) * b1 - b2 + float(coeffs[0])


def _cheb_on(coeffs: np.ndarray, x, a: float, b: float):
    t = torch.clamp(div(x - a, b - a), 0.0, 1.0)
    return _clenshaw(coeffs, t)


def _pq(n: int, x):
    """Hankel modulus/phase parts for |x| > 26 (DLMF 10.17.1; exact
    asymptotic coefficients, truncation error < 1e-25 for x >= 26)."""
    xs = torch.clamp_min(x, 1.0)
    v = div(1.0, xs * xs)
    pc = getattr(cf, f"P{n}_ASYMP")
    qc = getattr(cf, f"Q{n}_ASYMP")
    P = torch.zeros_like(xs) + float(pc[-1])
    for c in pc[-2::-1]:
        P = P * v + float(c)
    Q = torch.zeros_like(xs) + float(qc[-1])
    for c in qc[-2::-1]:
        Q = Q * v + float(c)
    Q = Q / xs
    w = xs - (2 * n + 1) * (np.pi / 4.0)
    fac = torch.sqrt(div(2.0, np.pi * xs))
    return P, Q, w, fac


def _piecewise_jy(n: int, kind: str, x, small):
    """4-branch select: small [0,8], MID1 [8,17], MID2 [17,26], asymptotic."""
    K = kind.upper()
    mid1 = _cheb_on(getattr(cf, f"{K}{n}_MID1"), x, 8.0, 17.0)
    mid2 = _cheb_on(getattr(cf, f"{K}{n}_MID2"), x, 17.0, 26.0)
    P, Q, w, fac = _pq(n, x)
    if K == "J":
        asym = fac * (P * torch.cos(w) - Q * torch.sin(w))
    else:
        asym = fac * (P * torch.sin(w) + Q * torch.cos(w))
    return torch.where(x <= 8.0, small,
                       torch.where(x <= 17.0, mid1,
                                   torch.where(x <= 26.0, mid2, asym)))


def bessel_j0(x, device=None):
    """J0(x) (bessel_0.rs; even function)."""
    x = torch.abs(f64(x, device))
    t = torch.clamp((x / 8.0) ** 2, 0.0, 1.0)
    small = _clenshaw(cf.J0_SMALL, t)
    return _piecewise_jy(0, "J", x, small)


def bessel_j1(x, device=None):
    """J1(x) (bessel_1.rs; odd function)."""
    x = f64(x, device)
    sgn = torch.sign(x)
    ax = torch.abs(x)
    t = torch.clamp((ax / 8.0) ** 2, 0.0, 1.0)
    small = ax * _clenshaw(cf.J1_SMALL, t)
    return sgn * _piecewise_jy(1, "J", ax, small)


def bessel_y0(x, device=None):
    """Y0(x); -inf at 0, NaN for x < 0 (bessel_0.rs)."""
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    t = torch.clamp((xs / 8.0) ** 2, 0.0, 1.0)
    small = _clenshaw(cf.Y0_SMALL, t) + TWO_BY_PI * torch.log(xs) * bessel_j0(
        xs)
    out = _piecewise_jy(0, "Y", xs, small)
    out = torch.where(x == 0.0, -math.inf, out)
    return torch.where(x < 0.0, math.nan, out)


def bessel_y1(x, device=None):
    """Y1(x); -inf at 0, NaN for x < 0 (bessel_1.rs)."""
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    t = torch.clamp((xs / 8.0) ** 2, 0.0, 1.0)
    small = (xs * _clenshaw(cf.Y1_SMALL, t) - div(TWO_BY_PI, xs)
             + TWO_BY_PI * torch.log(xs) * bessel_j1(xs))
    out = _piecewise_jy(1, "Y", xs, small)
    out = torch.where(x == 0.0, -math.inf, out)
    return torch.where(x < 0.0, math.nan, out)


def bessel_jn(n: int, x, device=None):
    """Jn(x) for integer n (bessel_n.rs): forward recurrence for n < |x|,
    Miller's backward recurrence otherwise (static trip counts)."""
    if n < 0:
        m = -n
        out = bessel_jn(m, x, device)
        return out if m % 2 == 0 else -out
    if n == 0:
        return bessel_j0(x, device)
    if n == 1:
        return bessel_j1(x, device)
    x = f64(x, device)
    sgn = torch.where((x < 0) & (n % 2 == 1), -1.0, 1.0).to(x.dtype)
    ax = torch.abs(x)
    axs = torch.clamp_min(ax, 1e-30)

    # upward recurrence (stable when n <= ax)
    jm, jc = bessel_j0(ax), bessel_j1(ax)
    for k in range(1, n):
        jm, jc = jc, div(2.0 * k, axs) * jc - jm
    up = jc

    # Miller's downward recurrence (stable when n > ax)
    m = 2 * ((n + int(np.sqrt(160.0 * n)) + 14) // 2)
    jp = torch.zeros_like(ax)
    jc2 = torch.ones_like(ax) * 1e-30
    s = torch.zeros_like(ax)
    ans = torch.zeros_like(ax)
    for k in range(m, 0, -1):
        jm2 = div(2.0 * k, axs) * jc2 - jp
        jp = jc2
        jc2 = jm2
        # renormalize to avoid overflow
        big = torch.abs(jc2) > 1e10
        jc2 = torch.where(big, jc2 * 1e-10, jc2)
        jp = torch.where(big, jp * 1e-10, jp)
        s = torch.where(big, s * 1e-10, s)
        ans = torch.where(big, ans * 1e-10, ans)
        if (k - 1) % 2 == 0:
            s = s + jc2
        if k == n:
            ans = jp
    s = 2.0 * s - jc2
    down = ans / s

    out = torch.where(ax >= n, up, down)
    out = torch.where(ax == 0.0, 0.0, out)
    return sgn * out


def bessel_yn(n: int, x, device=None):
    """Yn(x) by upward recurrence (stable for Y)."""
    if n < 0:
        m = -n
        out = bessel_yn(m, x, device)
        return out if m % 2 == 0 else -out
    if n == 0:
        return bessel_y0(x, device)
    if n == 1:
        return bessel_y1(x, device)
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    ym, yc = bessel_y0(xs), bessel_y1(xs)
    for k in range(1, n):
        ym, yc = yc, div(2.0 * k, xs) * yc - ym
    out = torch.where(x == 0.0, -math.inf, yc)
    return torch.where(x < 0.0, math.nan, out)


def bessel_i0(x, device=None):
    """Modified Bessel I0 (bessel_mod.rs; torch.special.i0)."""
    return torch.special.i0(f64(x, device))


def bessel_i1(x, device=None):
    """Modified Bessel I1 (bessel_mod.rs; torch.special.i1)."""
    return torch.special.i1(f64(x, device))


def bessel_in(n: int, x, device=None):
    """In(x) via Miller's downward recurrence (bessel_mod.rs)."""
    if n < 0:
        n = -n  # I_{-n} = I_n
    if n == 0:
        return bessel_i0(x, device)
    if n == 1:
        return bessel_i1(x, device)
    x = f64(x, device)
    sgn = torch.where((x < 0) & (n % 2 == 1), -1.0, 1.0).to(x.dtype)
    ax = torch.abs(x)
    axs = torch.clamp_min(ax, 1e-30)
    m = 2 * (n + int(np.sqrt(160.0 * n)) + 14)
    jp = torch.zeros_like(ax)
    jc = torch.ones_like(ax) * 1e-30
    ans = torch.zeros_like(ax)
    for k in range(m, 0, -1):
        jm = div(2.0 * k, axs) * jc + jp
        jp = jc
        jc = jm
        big = torch.abs(jc) > 1e10
        jc = torch.where(big, jc * 1e-10, jc)
        jp = torch.where(big, jp * 1e-10, jp)
        ans = torch.where(big, ans * 1e-10, ans)
        if k == n:
            ans = jp
    out = ans * torch.special.i0(ax) / jc
    out = torch.where(ax == 0.0, 0.0, out)
    return sgn * out


def bessel_k0(x, device=None):
    """K0(x); +inf at 0, NaN for x < 0 (bessel_mod.rs)."""
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    t_s = torch.clamp((xs / 2.0) ** 2, 0.0, 1.0)
    small = _clenshaw(cf.K0_SMALL, t_s) - torch.log(xs / 2.0) * \
        torch.special.i0(torch.clamp_max(xs, 3.0))
    t_l = torch.clamp(div(2.0, xs), 0.0, 1.0)
    large = _clenshaw(cf.K0_LARGE, t_l) * torch.exp(-xs) / torch.sqrt(xs)
    out = torch.where(xs <= 2.0, small, large)
    out = torch.where(x == 0.0, math.inf, out)
    return torch.where(x < 0.0, math.nan, out)


def bessel_k1(x, device=None):
    """K1(x); +inf at 0, NaN for x < 0."""
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    t_s = torch.clamp((xs / 2.0) ** 2, 0.0, 1.0)
    small = (xs * _clenshaw(cf.K1_SMALL, t_s) + div(1.0, xs)
             + torch.log(xs / 2.0) * torch.special.i1(
                 torch.clamp_max(xs, 3.0)))
    t_l = torch.clamp(div(2.0, xs), 0.0, 1.0)
    large = _clenshaw(cf.K1_LARGE, t_l) * torch.exp(-xs) / torch.sqrt(xs)
    out = torch.where(xs <= 2.0, small, large)
    out = torch.where(x == 0.0, math.inf, out)
    return torch.where(x < 0.0, math.nan, out)


def bessel_kn(n: int, x, device=None):
    """Kn(x) by upward recurrence (stable for K)."""
    if n < 0:
        n = -n
    if n == 0:
        return bessel_k0(x, device)
    if n == 1:
        return bessel_k1(x, device)
    x = f64(x, device)
    xs = torch.clamp_min(x, 1e-300)
    km, kc = bessel_k0(xs), bessel_k1(xs)
    for k in range(1, n):
        km, kc = kc, div(2.0 * k, xs) * kc + km
    out = torch.where(x == 0.0, math.inf, kc)
    return torch.where(x < 0.0, math.nan, out)
