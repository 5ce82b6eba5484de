"""Chebyshev polynomials + collocation point sets, in PyTorch.

Counterpart of ``russell_tpu.math.chebyshev`` (reference:
russell_lab/src/math/chebyshev.rs and chebyshev_u.rs). The polynomials
follow the device rule of ``core/_place.py``: a tensor computes in f64 on
its own device, a float, list or numpy array on ``device=`` (the card by
default). The point sets are host numpy arrays, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.core._place import f64

__all__ = ["chebyshev_tn", "chebyshev_tn_deriv1", "chebyshev_tn_deriv2",
           "chebyshev_un", "chebyshev_un_deriv1", "chebyshev_un_deriv2",
           "chebyshev_gauss_points", "chebyshev_lobatto_points"]


def chebyshev_tn(n: int, x, device=None):
    """Tn(x) via trigonometric/hyperbolic closed forms (chebyshev.rs)."""
    x = f64(x, device)
    inside = torch.abs(x) <= 1.0
    xc = torch.clamp(x, -1.0, 1.0)
    t_in = torch.cos(n * torch.arccos(xc))
    xo = torch.where(inside, 2.0, x)  # avoid acosh(<1) NaN
    t_pos = torch.cosh(n * torch.arccosh(torch.abs(xo)))
    t_out = torch.where(xo >= 1.0, t_pos, t_pos if n % 2 == 0 else -t_pos)
    return torch.where(inside, t_in, t_out)


def chebyshev_tn_deriv1(n: int, x, device=None):
    """dTn/dx = n Un-1(x)."""
    if n == 0:
        return torch.zeros_like(f64(x, device))
    return n * chebyshev_un(n - 1, x, device)


def chebyshev_tn_deriv2(n: int, x, device=None):
    """d²Tn/dx²; recurrence-based evaluation stable at x = +-1."""
    x = f64(x, device)
    if n < 2:
        return torch.zeros_like(x)
    # T'' via the ODE: (1-x²) Tn'' = x Tn' - n² Tn  away from |x| = 1;
    # at x = ±1: Tn''(±1) = (±1)^n n²(n²-1)/3
    t = chebyshev_tn(n, x)
    d1 = chebyshev_tn_deriv1(n, x)
    den = 1.0 - x * x
    safe = torch.abs(den) > 1e-10
    core = (x * d1 - (n * n) * t) / torch.where(safe, den, 1.0)
    lim = torch.sign(x) ** n * (n * n) * (n * n - 1.0) / 3.0
    return torch.where(safe, core, lim)


def chebyshev_un(n: int, x, device=None):
    """Un(x) (2nd kind) via the 3-term recurrence (chebyshev_u.rs)."""
    x = f64(x, device)
    um = torch.ones_like(x)
    if n == 0:
        return um
    uc = 2.0 * x
    for _ in range(1, n):
        um, uc = uc, 2.0 * x * uc - um
    return uc


def chebyshev_un_deriv1(n: int, x, device=None):
    """dUn/dx = ((n+1) T_{n+1} - x U_n)/(x²-1), limits at |x|=1."""
    x = f64(x, device)
    if n == 0:
        return torch.zeros_like(x)
    den = x * x - 1.0
    safe = torch.abs(den) > 1e-10
    core = ((n + 1) * chebyshev_tn(n + 1, x) - x * chebyshev_un(n, x)) \
        / torch.where(safe, den, 1.0)
    lim = torch.sign(x) ** (n + 1) * n * (n + 1.0) * (n + 2.0) / 3.0
    return torch.where(safe, core, lim)


def chebyshev_un_deriv2(n: int, x, device=None):
    """d²Un/dx² via the ODE (1-x²) Un'' = 3x Un' - n(n+2) Un."""
    x = f64(x, device)
    if n < 2:
        return torch.zeros_like(x)
    den = 1.0 - x * x
    safe = torch.abs(den) > 1e-10
    d1 = chebyshev_un_deriv1(n, x)
    core = (3.0 * x * d1 - n * (n + 2.0) * chebyshev_un(n, x)) \
        / torch.where(safe, den, 1.0)
    lim_p = (n - 1.0) * n * (n + 1.0) * (n + 2.0) * (n + 3.0) / 15.0 \
        * torch.sign(x) ** n
    return torch.where(safe, core, lim_p)


def chebyshev_gauss_points(nn: int) -> np.ndarray:
    """nn+1 Chebyshev-Gauss points in [-1, 1], ascending
    (chebyshev.rs: -cos(pi (2i+1)/(2N+2)))."""
    i = np.arange(nn + 1)
    return -np.cos(np.pi * (2 * i + 1) / (2 * nn + 2))


def chebyshev_lobatto_points(nn: int) -> np.ndarray:
    """nn+1 Chebyshev-Gauss-Lobatto points in [-1, 1], ascending
    (chebyshev.rs: -cos(pi i / N))."""
    i = np.arange(nn + 1)
    return -np.cos(np.pi * i / nn) if nn > 0 else np.zeros(1)
