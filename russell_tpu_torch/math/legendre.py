"""Legendre polynomials and Gauss/Lobatto quadrature points/weights.

Counterpart of ``russell_tpu.math.legendre`` (reference:
russell_lab/src/math/legendre.rs). The polynomials follow the device rule
of ``core/_place.py`` (a tensor's device, else ``device=``, the card by
default). The point and weight sets are host numpy, as in the reference:
points by Newton iteration on the recurrence-evaluated Pn, weights from
the classical closed forms.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.core._place import f64

__all__ = ["legendre_pn", "legendre_pn_deriv1", "legendre_pn_deriv2",
           "legendre_gauss_points", "legendre_gauss_weights",
           "legendre_lobatto_points", "legendre_lobatto_weights"]


def legendre_pn(n: int, x, device=None):
    """Pn(x) by the Bonnet recurrence."""
    x = f64(x, device)
    pm = torch.ones_like(x)
    if n == 0:
        return pm
    pc = x
    for k in range(1, n):
        pm, pc = pc, ((2 * k + 1) * x * pc - k * pm) / torch.full(
            (), k + 1.0, dtype=x.dtype, device=x.device)
    return pc


def legendre_pn_deriv1(n: int, x, device=None):
    """dPn/dx = n (x Pn - Pn-1)/(x²-1), limits at |x| = 1."""
    x = f64(x, device)
    if n == 0:
        return torch.zeros_like(x)
    den = x * x - 1.0
    safe = torch.abs(den) > 1e-10
    core = n * (x * legendre_pn(n, x) - legendre_pn(n - 1, x)) \
        / torch.where(safe, den, 1.0)
    lim = torch.sign(x) ** (n + 1) * n * (n + 1.0) / 2.0
    return torch.where(safe, core, lim)


def legendre_pn_deriv2(n: int, x, device=None):
    """d²Pn/dx² from the Legendre ODE; limits at |x| = 1."""
    x = f64(x, device)
    if n < 2:
        return torch.zeros_like(x)
    den = 1.0 - x * x
    safe = torch.abs(den) > 1e-10
    core = (2.0 * x * legendre_pn_deriv1(n, x)
            - n * (n + 1.0) * legendre_pn(n, x)) / torch.where(safe, den, 1.0)
    lim = torch.sign(x) ** n * (n - 1.0) * n * (n + 1.0) * (n + 2.0) / 8.0
    return torch.where(safe, core, lim)


def _pn_and_deriv_np(n, x):
    pm = np.ones_like(x)
    pc = x.copy()
    for k in range(1, n):
        pm, pc = pc, ((2 * k + 1) * x * pc - k * pm) / (k + 1)
    den = x * x - 1.0
    d = n * (x * pc - pm) / np.where(np.abs(den) > 1e-300, den, 1.0)
    return pc, d, pm


def legendre_gauss_points(nn: int) -> np.ndarray:
    """nn+1 Gauss-Legendre points (roots of P_{nn+1}), ascending; host
    numpy, as in the reference."""
    n = nn + 1
    i = np.arange(1, n + 1)
    x = np.cos(np.pi * (i - 0.25) / (n + 0.5))  # Tricomi initial guess
    for _ in range(100):
        p, d, _ = _pn_and_deriv_np(n, x)
        dx = p / d
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    return np.sort(x)


def legendre_gauss_weights(nn: int) -> np.ndarray:
    """w_i = 2/((1-x²) Pn'(x)²)."""
    x = legendre_gauss_points(nn)
    _, d, _ = _pn_and_deriv_np(nn + 1, x)
    return 2.0 / ((1.0 - x * x) * d * d)


def legendre_lobatto_points(nn: int) -> np.ndarray:
    """nn+1 Gauss-Lobatto-Legendre points (±1 and roots of P'_nn)."""
    n = nn
    if n == 1:
        return np.array([-1.0, 1.0])
    # interior: roots of P'_n -> Newton on derivative
    i = np.arange(1, n)
    x = np.cos(np.pi * (i - 0.25) / (n - 0.5))  # rough guesses interior
    # better initial guess: average of Chebyshev-Lobatto neighbors
    x = -np.cos(np.pi * i / n)
    for _ in range(100):
        p, d, pm = _pn_and_deriv_np(n, x)
        # d2 from the ODE
        d2 = (2.0 * x * d - n * (n + 1.0) * p) / (1.0 - x * x)
        dx = d / d2
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    return np.concatenate([[-1.0], np.sort(x), [1.0]])


def legendre_lobatto_weights(nn: int) -> np.ndarray:
    """w_i = 2/(N(N+1) Pn(x_i)²) with N = nn."""
    x = legendre_lobatto_points(nn)
    n = nn
    p, _, _ = _pn_and_deriv_np(n, x)
    return 2.0 / (n * (n + 1.0) * p * p)
