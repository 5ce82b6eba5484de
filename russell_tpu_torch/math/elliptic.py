"""Elliptic integrals (reference: russell_lab/src/math/elliptic.rs).

Counterpart of ``russell_tpu.math.elliptic``: elliptic_f(phi, m),
elliptic_e(phi, m), elliptic_pi(n, phi, m) — Legendre forms with
parameter m = k² — through Carlson's symmetric forms RF/RD/RJ/RC with the
duplication algorithm (Carlson 1995). The reference's fixed-length
``lax.scan``s are fixed Python loops over tensors here (``_N_DUP`` = 26
duplications; 14 for RJ, each with an RC of 26), one eager launch an
operation. Every function follows the device rule of ``core/_place.py``:
the first tensor argument's device, else ``device=``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.core._place import div, on

__all__ = ["elliptic_f", "elliptic_e", "elliptic_pi",
           "carlson_rf", "carlson_rd", "carlson_rj", "carlson_rc"]

_N_DUP = 26  # each duplication quarters the arguments' spread
_N_DUP_RJ = 14


def _args(*xs, device=None):
    return torch.broadcast_tensors(*on(*xs, device=device,
                                       dtype=torch.float64))


def carlson_rf(x, y, z, device=None):
    """Carlson RF(x, y, z) — symmetric elliptic integral of the 1st kind."""
    x, y, z = _args(x, y, z, device=device)
    for _ in range(_N_DUP):
        sx, sy, sz = torch.sqrt(x), torch.sqrt(y), torch.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        x, y, z = (x + lam) / 4, (y + lam) / 4, (z + lam) / 4
    mu = div(x + y + z, 3.0)
    dx = 1.0 - x / mu
    dy = 1.0 - y / mu
    dz = 1.0 - z / mu
    e2 = dx * dy + dy * dz + dz * dx
    e3 = dx * dy * dz
    s = (1.0 - div(e2, 10.0) + div(e3, 14.0) + div(e2 * e2, 24.0)
         - div(3.0 * e2 * e3, 44.0))
    return s / torch.sqrt(mu)


def carlson_rc(x, y, device=None):
    """Carlson RC(x, y) (degenerate RF)."""
    return carlson_rf(x, y, y, device=device)


def carlson_rd(x, y, z, device=None):
    """Carlson RD(x, y, z) — symmetric integral of the 2nd kind."""
    x, y, z = _args(x, y, z, device=device)
    ssum = torch.zeros_like(x)
    fac = torch.ones_like(x)
    for _ in range(_N_DUP):
        sx, sy, sz = torch.sqrt(x), torch.sqrt(y), torch.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        ssum = ssum + fac / (sz * (z + lam))
        fac = fac / 4.0
        x, y, z = (x + lam) / 4, (y + lam) / 4, (z + lam) / 4
    mu = div(x + y + 3.0 * z, 5.0)
    dx = 1.0 - x / mu
    dy = 1.0 - y / mu
    dz = 1.0 - z / mu
    ea = dx * dy
    eb = dz * dz
    ec = ea - eb
    ed = ea - 6.0 * eb
    ee = ed + 2.0 * ec
    s = (1.0 + ed * (-3.0 / 14.0 + 9.0 / 88.0 * ed - 4.5 / 26.0 * dz * ee)
         + dz * (1.0 / 6.0 * ee + dz * (-9.0 / 22.0 * ec
                                        + 3.0 / 26.0 * dz * ea)))
    return 3.0 * ssum + fac * s / (mu * torch.sqrt(mu))


def carlson_rj(x, y, z, p, device=None):
    """Carlson RJ(x, y, z, p) — symmetric integral of the 3rd kind
    (p > 0 branch)."""
    x, y, z, p = _args(x, y, z, p, device=device)
    ssum = torch.zeros_like(x)
    fac = torch.ones_like(x)
    for _ in range(_N_DUP_RJ):
        sx, sy, sz = torch.sqrt(x), torch.sqrt(y), torch.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        alpha = (p * (sx + sy + sz) + sx * sy * sz) ** 2
        beta = p * (p + lam) ** 2
        ssum = ssum + fac * carlson_rc(alpha, beta)
        fac = fac / 4.0
        x, y, z, p = ((x + lam) / 4, (y + lam) / 4, (z + lam) / 4,
                      (p + lam) / 4)
    mu = div(x + y + z + 2.0 * p, 5.0)
    dx = 1.0 - x / mu
    dy = 1.0 - y / mu
    dz = 1.0 - z / mu
    dp = 1.0 - p / mu
    ea = dx * (dy + dz) + dy * dz
    eb = dx * dy * dz
    ec = dp * dp
    ed = ea - 3.0 * ec
    ee = eb + 2.0 * dp * (ea - ec)
    s = (1.0 + ed * (-3.0 / 14.0 + 9.0 / 88.0 * ed - 4.5 / 26.0 * ee)
         + eb * (1.0 / 6.0 + dp * (-6.0 / 22.0 + dp * 3.0 / 26.0))
         + dp * ea * (1.0 / 3.0 - dp * 3.0 / 22.0) - 1.0 / 3.0 * dp * ec)
    return 3.0 * ssum + fac * s / (mu * torch.sqrt(mu))


_EPS = float(np.finfo(np.float64).eps)


def elliptic_f(phi, m, device=None):
    """Incomplete elliptic integral of the 1st kind F(phi, m), m = k²
    (elliptic.rs: elliptic_f). Requires 0 <= phi <= pi/2, m sin²phi <= 1."""
    phi, m = _args(phi, m, device=device)
    s = torch.sin(phi)
    c2 = torch.cos(phi) ** 2
    mss = m * s * s
    q = 1.0 - mss
    out = s * carlson_rf(c2, torch.clamp_min(q, 1e-300), torch.ones_like(q))
    # m sin²φ == 1: F diverges (elliptic.rs:72-74 contract)
    out = torch.where(torch.abs(mss - 1.0) < 10 * _EPS, math.inf, out)
    bad = (phi < 0) | (phi > np.pi / 2 + 1e-14) | (mss > 1.0 + 10 * _EPS)
    return torch.where(bad, math.nan, out)


def elliptic_e(phi, m, device=None):
    """Incomplete elliptic integral of the 2nd kind E(phi, m)."""
    phi, m = _args(phi, m, device=device)
    s = torch.sin(phi)
    c2 = torch.cos(phi) ** 2
    q = 1.0 - m * s * s
    qs = torch.clamp_min(q, 1e-300)
    one = torch.ones_like(q)
    out = s * (carlson_rf(c2, qs, one)
               - div(m * s * s, 3.0) * carlson_rd(c2, qs, one))
    # m sin2 == 1 edge: E(phi, 1) = sin(phi)
    out = torch.where(torch.abs(q) < 1e-15, s, out)
    bad = (phi < 0) | (phi > np.pi / 2 + 1e-14) | (m * s * s > 1.0 + 1e-14)
    return torch.where(bad, math.nan, out)


def elliptic_pi(n, phi, m, device=None):
    """Incomplete elliptic integral of the 3rd kind Pi(n; phi, m) with the
    reference's sign convention (elliptic.rs: integrand
    1/((1 - n sin²t) sqrt(1 - m sin²t)))."""
    n, phi, m = _args(n, phi, m, device=device)
    s = torch.sin(phi)
    c2 = torch.cos(phi) ** 2
    mss = m * s * s
    q = 1.0 - mss
    ns2 = n * s * s
    qs = torch.clamp_min(q, 1e-300)
    one = torch.ones_like(q)
    out = s * (carlson_rf(c2, qs, one)
               + div(ns2, 3.0)
               * carlson_rj(c2, qs, one, torch.clamp_min(1.0 - ns2, 1e-300)))
    # m sin²φ == 1 or n sin²φ == 1: Π diverges (elliptic.rs:222-228)
    sing = (torch.abs(mss - 1.0) < 10 * _EPS) | (
        torch.abs(ns2 - 1.0) < 10 * _EPS)
    out = torch.where(sing, math.inf, out)
    bad = ((phi < 0) | (phi > np.pi / 2 + 1e-14)
           | (mss > 1.0 + 10 * _EPS) | (ns2 > 1.0 + 10 * _EPS))
    return torch.where(bad & ~sing, math.nan, out)
