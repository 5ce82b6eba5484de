"""Analytic-solution test problems (reference:
russell_pde/src/problem_samples.rs — the test_{1d,2d}_prob* oracles).

Counterpart of ``russell_tpu.pde.problem_samples``, copied (host numpy,
as in the reference)."""

from __future__ import annotations

import math

from russell_tpu_torch.pde.bcs import (EssentialBcs1d, EssentialBcs2d,
                                       NaturalBcs1d, NaturalBcs2d)
from russell_tpu_torch.pde.enums import Side

__all__ = ["d1_problem_01", "d1_problem_02", "d1_problem_03",
           "d1_problem_04a", "d1_problem_04b", "d1_problem_05",
           "d2_problem_01", "d2_problem_02", "d2_problem_03",
           "d2_problem_04", "d2_problem_05", "d2_problem_06",
           "d2_problem_07"]

PI = math.pi


def d1_problem_01():
    """-phi'' = x on [0,1], homogeneous Dirichlet; phi = (x - x^3)/6
    (problem_samples.rs:38)."""
    xmin, xmax, kx = 0.0, 1.0, 1.0
    ebcs = EssentialBcs1d().set_homogeneous()
    nbcs = NaturalBcs1d()
    source = lambda x: x
    analytical = lambda x: (x - x ** 3) / 6.0
    ana_flow = lambda x: -kx * (1.0 - 3.0 * x * x) / 6.0
    return xmin, xmax, kx, ebcs, nbcs, source, analytical, ana_flow


def d1_problem_02():
    """Heat rod: -k phi'' + alpha phi = alpha*20 on [0, 0.05], Dirichlet
    320 at left, insulated (zero-flux) right (problem_samples.rs:120)."""
    xmin, xmax = 0.0, 0.05
    kx = 0.01571
    alpha = 2.0 * PI
    t_env = 20.0
    t_left = 320.0
    ebcs = EssentialBcs1d()
    ebcs.set(Side.XMIN, lambda x: t_left)
    nbcs = NaturalBcs1d()
    nbcs.set(Side.XMAX, lambda x: 0.0)
    source = lambda x: alpha * t_env
    mu = math.sqrt(alpha / kx)
    L = xmax - xmin

    def analytical(x):
        return t_env + (t_left - t_env) * (
            math.cosh(mu * (L - x)) / math.cosh(mu * L))

    return xmin, xmax, kx, alpha, ebcs, nbcs, source, analytical


def d2_problem_01(case_a: bool = True):
    """Poisson with phi = x y (x-1)(y-1) e^(x-y) on the unit square
    (problem_samples.rs:469)."""
    xmin, xmax, ymin, ymax = 0.0, 1.0, 0.0, 1.0
    kx = ky = 1.0
    ebcs = EssentialBcs2d()
    nbcs = NaturalBcs2d()
    if case_a:
        ebcs.set_homogeneous()
    else:
        nbcs.set(Side.XMIN,
                 lambda x, y: -kx * math.exp(-y) * (y - 1.0) * y)
        nbcs.set(Side.YMIN,
                 lambda x, y: -ky * math.exp(x) * (x - 1.0) * x)
        ebcs.set(Side.XMAX, lambda x, y: 0.0)
        ebcs.set(Side.YMAX, lambda x, y: 0.0)
    source = lambda x, y: (2.0 * x * (1.0 - y) * (y - 2.0 * x + x * y + 2.0)
                           * math.exp(x - y))
    analytical = lambda x, y: x * y * (x - 1.0) * (y - 1.0) * math.exp(x - y)

    def ana_flow(x, y):
        return (-kx * math.exp(x - y) * (x * x + x - 1.0) * (y - 1.0) * y,
                -ky * math.exp(x - y) * (y * y - 3.0 * y + 1.0)
                * (1.0 - x) * x)

    return (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical,
            ana_flow)


def d2_problem_02():
    """Laplace-type with phi = y sin(pi x) (problem_samples.rs:547).

    Note kx = ky = -1 as in the reference (the operator reads
    +d2/dx2 + d2/dy2 = s)."""
    xmin, xmax, ymin, ymax = 0.0, 1.0, 0.0, 1.0
    kx = ky = -1.0
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: 0.0)
    ebcs.set(Side.XMAX, lambda x, y: 0.0)
    ebcs.set(Side.YMIN, lambda x, y: 0.0)
    ebcs.set(Side.YMAX, lambda x, y: math.sin(PI * x))
    nbcs = NaturalBcs2d()
    source = lambda x, y: -PI * PI * y * math.sin(PI * x)
    analytical = lambda x, y: y * math.sin(PI * x)
    return xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical


def d2_problem_03(k: float = 1.0, alpha: float = 0.0,
                  bc_combo: str = "DDDD"):
    """-k lap(phi) + alpha phi = s with phi = sin(2 pi x) cos(2 pi y)
    and mixed Dirichlet/Neumann combos (problem_samples.rs:618)."""
    xmin, xmax, ymin, ymax = 0.0, 1.0, 0.0, 1.0
    ebcs = EssentialBcs2d()
    nbcs = NaturalBcs2d()
    analytical = lambda x, y: math.sin(2 * PI * x) * math.cos(2 * PI * y)
    # flux on a side: wn = -k dphi/dn
    dphi_dx = lambda x, y: 2 * PI * math.cos(2 * PI * x) * math.cos(2 * PI * y)
    dphi_dy = lambda x, y: -2 * PI * math.sin(2 * PI * x) * math.sin(2 * PI * y)
    flux = {
        Side.XMIN: lambda x, y: -k * (-dphi_dx(x, y)),
        Side.XMAX: lambda x, y: -k * dphi_dx(x, y),
        Side.YMIN: lambda x, y: -k * (-dphi_dy(x, y)),
        Side.YMAX: lambda x, y: -k * dphi_dy(x, y),
    }
    # bc_combo order: Xmax, Ymax, Xmin, Ymin (problem_samples.rs doc)
    order = [Side.XMAX, Side.YMAX, Side.XMIN, Side.YMIN]
    if len(bc_combo) != 4 or any(c not in "DN" for c in bc_combo):
        raise ValueError("bc_combo must be 4 chars of D/N")
    for c, side in zip(bc_combo, order):
        if c == "D":
            ebcs.set(side, lambda x, y, a=analytical: a(x, y))
        else:
            nbcs.set(side, flux[side])
    source = lambda x, y: (8.0 * k * PI * PI + alpha) * analytical(x, y)
    return xmin, xmax, ymin, ymax, k, k, ebcs, nbcs, source, analytical


def d1_problem_03():
    """-phi'' + phi = x^2 with phi(0)=2, wn(1)=-3; analytical
    sinh(x)/cosh(1) + x^2 + 2 (problem_samples.rs:202)."""
    xmin, xmax, kx, alpha = 0.0, 1.0, 1.0, 1.0
    ebcs = EssentialBcs1d()
    nbcs = NaturalBcs1d()
    ebcs.set(Side.XMIN, lambda x: 2.0)
    nbcs.set(Side.XMAX, lambda x: -3.0)
    source = lambda x: x * x
    analytical = lambda x: math.sinh(x) / math.cosh(1.0) + x * x + 2.0
    return xmin, xmax, kx, alpha, ebcs, nbcs, source, analytical


def d2_problem_04(ana_nsum: int = 101):
    """-lap(phi) = 1 on [-1,1]^2, homogeneous Dirichlet; Fourier-series
    analytical solution (problem_samples.rs:729)."""
    xmin, xmax, ymin, ymax = -1.0, 1.0, -1.0, 1.0
    kx = ky = 1.0
    ebcs = EssentialBcs2d()
    ebcs.set_homogeneous()
    nbcs = NaturalBcs2d()
    source = lambda x, y: 1.0

    def analytical(x, y):
        s = 0.0
        for k in range(1, ana_nsum, 2):
            kp = k * PI
            ak = kp * (1.0 + x) / 2.0
            sak = math.sin(ak)
            if sak != 0.0:
                s += sak * (math.sinh(kp * (1.0 + y) / 2.0)
                            + math.sinh(kp * (1.0 - y) / 2.0)) \
                    / (k ** 3 * math.sinh(kp))
        return (1.0 - x * x) / 2.0 - 16.0 * s / PI ** 3

    return xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical


def d2_problem_05():
    """-lap(phi) = -6x on [-1,1]^2 with Dirichlet on x-sides and zero
    flux on y-sides; analytical 1 + x^3 (problem_samples.rs:800)."""
    xmin, xmax, ymin, ymax = -1.0, 1.0, -1.0, 1.0
    kx = ky = 1.0
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: 0.0)
    ebcs.set(Side.XMAX, lambda x, y: 2.0)
    nbcs = NaturalBcs2d()
    nbcs.set(Side.YMIN, lambda x, y: 0.0)
    nbcs.set(Side.YMAX, lambda x, y: 0.0)
    source = lambda x, y: -6.0 * x
    analytical = lambda x, y: 1.0 + x ** 3
    return xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical


def d2_problem_06():
    """-lap(phi) = 4 tanh(u)/cosh(u)^2 with u = 1 - x + y; mixed
    Dirichlet/Neumann; analytical tanh(1 - x + y)
    (problem_samples.rs:867)."""
    xmin, xmax, ymin, ymax = -1.0, 1.0, -1.0, 1.0
    kx = ky = 1.0
    analytical = lambda x, y: math.tanh(1.0 - x + y)
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: math.tanh(2.0 + y))
    ebcs.set(Side.YMIN, lambda x, y: -math.tanh(x))
    ebcs.set(Side.YMAX, lambda x, y: math.tanh(2.0 - x))
    nbcs = NaturalBcs2d()
    nbcs.set(Side.XMAX, lambda x, y: 1.0 / math.cosh(y) ** 2)
    source = lambda x, y: (4.0 * math.tanh(1.0 - x + y)
                           / math.cosh(1.0 - x + y) ** 2)
    return xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical


def d2_problem_07():
    """lap(phi) = -8 pi^2 cos(2 pi x) sin(2 pi y) — Kopriva benchmark
    5.2.1.7; analytical cos(2 pi x) sin(2 pi y)
    (problem_samples.rs:940)."""
    xmin, xmax, ymin, ymax = -1.0, 1.0, -1.0, 1.0
    kx = ky = 1.0
    analytical = lambda x, y: math.cos(2 * PI * x) * math.sin(2 * PI * y)
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: math.sin(2 * PI * y))
    ebcs.set(Side.XMAX, lambda x, y: math.sin(2 * PI * y))
    ebcs.set(Side.YMIN, lambda x, y: 0.0)
    ebcs.set(Side.YMAX, lambda x, y: 0.0)
    nbcs = NaturalBcs2d()
    source = lambda x, y: (8.0 * PI * PI * math.cos(2 * PI * x)
                           * math.sin(2 * PI * y))
    return xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical


def d1_problem_04a():
    """phi'' = exp(4x) on [-1,1], homogeneous Dirichlet (Trefethen
    Program 13; problem_samples.rs:266). kx = -1 makes the operator
    +d2/dx2."""
    xmin, xmax, kx = -1.0, 1.0, -1.0
    ebcs = EssentialBcs1d()
    ebcs.set_homogeneous()
    nbcs = NaturalBcs1d()
    source = lambda x: math.exp(4.0 * x)
    analytical = lambda x: (math.exp(4.0 * x) - math.sinh(4.0) * x
                            - math.cosh(4.0)) / 16.0
    return xmin, xmax, kx, ebcs, nbcs, source, analytical


def d1_problem_04b():
    """phi'' = exp(4x) with a zero-flux left end
    (problem_samples.rs:325)."""
    xmin, xmax, kx = -1.0, 1.0, -1.0
    ebcs = EssentialBcs1d()
    ebcs.set(Side.XMAX, lambda x: 0.0)
    nbcs = NaturalBcs1d()
    nbcs.set(Side.XMIN, lambda x: 0.0)
    source = lambda x: math.exp(4.0 * x)
    analytical = lambda x: (math.exp(4.0 * x)
                            - 4.0 * math.exp(-4.0) * (x - 1.0)
                            - math.exp(4.0)) / 16.0
    return xmin, xmax, kx, ebcs, nbcs, source, analytical


def d1_problem_05(beta: float, ll: float, g0: float, phi_ll: float):
    """phi'' + beta^2 phi = 0 (solve with alpha = beta^2, kx = -1):
    flux g0 at x=0, phi(ll) prescribed (problem_samples.rs:393).
    Returns (..., source, analytical, ana_flow)."""
    xmin, xmax, kx = 0.0, ll, -1.0
    ebcs = EssentialBcs1d()
    nbcs = NaturalBcs1d()
    ebcs.set(Side.XMAX, lambda x: phi_ll)
    nbcs.set(Side.XMIN, lambda x: -g0)
    source = lambda x: 0.0

    def analytical(x):
        c1 = g0 / beta
        c2 = (phi_ll - c1 * math.sin(beta * ll)) / math.cos(beta * ll)
        return c1 * math.sin(beta * x) + c2 * math.cos(beta * x)

    def ana_flow(x):
        return (-kx) * ((g0 * math.cos(beta * (ll - x))
                         - beta * phi_ll * math.sin(beta * x))
                        / math.cos(beta * ll))

    return xmin, xmax, kx, ebcs, nbcs, source, analytical, ana_flow
