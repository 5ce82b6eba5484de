"""Canonical ODE/DAE test problems (reference: russell_ode/src/samples.rs).

Counterpart of ``russell_tpu.ode.samples``: each sample returns the same
tuple as the reference package's, with the rhs ``f(x, y, args) -> ydot``
and the Jacobian values aligned with a frozen (ii, jj) structure (see
``ode.system.System``), plus initial values and reference solutions
(``y_fn_x`` on the host) where the reference has them. ``f`` and ``jac``
take torch tensors and compute on the device of ``y``; their constant
tables are uploaded to a device once, at its first use. The arithmetic
follows the reference package's operation by operation. Every ``f`` is
functional (no in-place writes on ``y``), so the autodiff and numerical
Jacobians can trace it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.ode.system import System
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import Sym

__all__ = [
    "simple_equation_constant", "simple_system_with_mass_matrix",
    "brusselator_ode", "brusselator_pde", "arenstorf", "hairer_wanner_eq1",
    "robertson", "van_der_pol", "amplifier1t", "kreyszig_eq6_page902",
    "kreyszig_ex4_page920",
]


def _per_device(**arrays):
    """``get(name, device)``: the numpy ``arrays`` as tensors on
    ``device``, uploaded once per device."""
    cache = {}

    def get(name, device):
        key = (name, device)
        t = cache.get(key)
        if t is None:
            t = cache[key] = torch.as_tensor(arrays[name], device=device)
        return t

    return get


# x reaches a system function as a float on the host-stepped path and as a
# 0-d tensor on the device on the fused one, where a host read (math.cos
# of a tensor) would stop the graph's capture: the same functions take both
def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else math.sin(x)


def simple_equation_constant():
    """y' = 1, y(0) = 0 (samples.rs:44)."""
    const = _per_device(jac=np.zeros(1))
    system = System(1, lambda x, y, args: torch.ones_like(y))
    system.set_jacobian(([0], [0]),
                        lambda x, y, args: const("jac", y.device))
    y_fn_x = lambda x, args: np.array([x])
    return system, 0.0, np.array([0.0]), None, y_fn_x


def simple_system_with_mass_matrix(lower_triangle: bool = False):
    """3-dim DAE-style system with constant mass matrix (samples.rs:152).

    M y' = f with y_ana = (cos x, -sin x, ln(1+x))."""
    def f(x, y, args):
        third = 1.0 / (1.0 + x)
        if not isinstance(third, torch.Tensor):
            third = torch.full((), third, dtype=y.dtype, device=y.device)
        return torch.stack([-y[0] + y[1], y[0] + y[1], third.to(y.dtype)])

    system = System(3, f)
    ii = [0, 0, 1, 1]
    jj = [0, 1, 0, 1]
    const = _per_device(jac=np.array([-1.0, 1.0, 1.0, 1.0]))
    system.set_jacobian((ii, jj), lambda x, y, args: const("jac", y.device))
    sym = Sym.YES_LOWER if lower_triangle else Sym.NO
    mass = CooMatrix(3, 3, 5, sym)
    mass.put(0, 0, 1.0)
    if not lower_triangle:
        mass.put(0, 1, 1.0)
    mass.put(1, 0, 1.0)
    mass.put(1, 1, -1.0)
    mass.put(2, 2, 1.0)
    system.set_mass(mass)
    y_fn_x = lambda x, args: np.array([math.cos(x), -math.sin(x),
                                       math.log(1.0 + x)])
    return system, 0.0, np.array([1.0, 0.0, 0.0]), None, y_fn_x


def brusselator_ode():
    """2-dim stiff-ish Brusselator (samples.rs:263); y_ref from Mathematica."""
    def f(x, y, args):
        return torch.stack([1.0 - 4.0 * y[0] + y[0] * y[0] * y[1],
                            3.0 * y[0] - y[0] * y[0] * y[1]])

    system = System(2, f)

    def jac(x, y, args):
        return torch.stack([-4.0 + 2.0 * y[0] * y[1], y[0] * y[0],
                            3.0 - 2.0 * y[0] * y[1], -y[0] * y[0]])

    system.set_jacobian(([0, 0, 1, 1], [0, 1, 0, 1]), jac)
    y_ref = np.array([0.4986370712683478291402659846476,
                      4.596780349452011024598321237263])
    return system, 0.0, np.array([1.5, 3.0]), None, y_ref


def brusselator_pde(alpha: float, npoint: int, second_book: bool = False,
                    ignore_diffusion: bool = False):
    """2-D Brusselator reaction-diffusion on an npoint² grid
    (samples.rs:497; HW-I Fig 10.4 / HW-II Fig 10.7).

    ndim = 2·npoint²; the sparse Jacobian has 4 diagonal blocks plus two
    discrete-Laplacian bands (5-point molecule, Neumann ghost-mirroring or
    periodic wrap as in russell_pde fdm_2d.rs:959-972).
    """
    nx = ny = npoint
    s = nx * ny
    ndim = 2 * s
    dx = 1.0 / (nx - 1)
    dy = 1.0 / (ny - 1)
    kx = ky = -alpha
    mol = np.array([2.0 * (kx / dx**2 + ky / dy**2), -kx / dx**2, -kx / dx**2,
                    -ky / dy**2, -ky / dy**2])

    m = np.arange(s)
    i = m % nx
    j = m // nx
    nn = np.zeros((5, s), dtype=np.int64)
    nn[0] = m
    if second_book:  # periodic
        nn[1] = np.where(i != 0, m - 1, m + (nx - 1))
        nn[2] = np.where(i != nx - 1, m + 1, m - (nx - 1))
        nn[3] = np.where(j != 0, m - nx, m + (ny - 1) * nx)
        nn[4] = np.where(j != ny - 1, m + nx, m - (ny - 1) * nx)
    else:  # Neumann zero-flux: mirror ghosts
        nn[1] = np.where(i != 0, m - 1, m + 1)
        nn[2] = np.where(i != nx - 1, m + 1, m - 1)
        nn[3] = np.where(j != 0, m - nx, m + nx)
        nn[4] = np.where(j != ny - 1, m + nx, m - nx)
    dxs = i * dx - 0.3
    dys = j * dy - 0.6
    inh = np.where(dxs * dxs + dys * dys <= 0.01, 5.0, 0.0)
    # the constant Laplacian entries of the Jacobian, in structure order
    lap_vals = (np.repeat(mol, 2 * s) if not ignore_diffusion
                else np.zeros(0))
    const = _per_device(nn=nn, mol=mol, inh=inh, lap_vals=lap_vals)

    def f(t, yy, args):
        dev = yy.device
        u = yy[:s]
        v = yy[s:]
        u2v = u * u * v
        fu = 1.0 - 4.4 * u + u2v
        fv = 3.4 * u - u2v
        if not ignore_diffusion:
            nn_d = const("nn", dev)
            mol_d = const("mol", dev)
            lap_u = torch.zeros_like(u)
            lap_v = torch.zeros_like(v)
            for b in range(5):
                lap_u = lap_u + mol_d[b] * u[nn_d[b]]
                lap_v = lap_v + mol_d[b] * v[nn_d[b]]
            fu = fu + lap_u
            fv = fv + lap_v
        if second_book:
            if isinstance(t, torch.Tensor):
                fu = fu + torch.where(t >= 1.1, const("inh", dev), 0.0)
            elif t >= 1.1:
                fu = fu + const("inh", dev)
        return torch.cat([fu, fv])

    system = System(ndim, f)

    # Jacobian structure: 4 diagonal blocks + 2 Laplacian bands
    ii = [m, m, s + m, s + m]
    jj = [m, s + m, m, s + m]
    if not ignore_diffusion:
        for b in range(5):
            ii.extend([m, s + m])
            jj.extend([nn[b], s + nn[b]])
    ii = np.concatenate(ii)
    jj = np.concatenate(jj)

    def jac(t, yy, args):
        u = yy[:s]
        v = yy[s:]
        u2 = u * u
        parts = [-4.4 + 2.0 * u * v, u2, 3.4 - 2.0 * u * v, -u2,
                 const("lap_vals", yy.device)]
        return torch.cat(parts)

    system.set_jacobian((ii, jj), jac)
    if not second_book:
        # grid-structure hint: cell m = j*nx + i, vars species-major
        system.grid = (ny, nx, 2)

    xi = np.asarray(i * dx)
    yi = np.asarray(j * dy)
    if second_book:
        u0 = 22.0 * yi * np.power(1.0 - yi, 1.5)
        v0 = 27.0 * xi * np.power(1.0 - xi, 1.5)
    else:
        u0 = 0.5 + yi
        v0 = 1.0 + 5.0 * xi
    yy0 = np.concatenate([u0, v0])
    return system, 0.0, yy0, None


def arenstorf():
    """Restricted three-body Arenstorf orbit (samples.rs:664)."""
    MU = 0.012277471
    MD = 1.0 - MU

    def f(x, y, args):
        t0 = (y[0] + MU) ** 2 + y[1] ** 2
        t1 = (y[0] - MD) ** 2 + y[1] ** 2
        d0 = t0 * torch.sqrt(t0)
        d1 = t1 * torch.sqrt(t1)
        return torch.stack([
            y[2],
            y[3],
            y[0] + 2.0 * y[3] - MD * (y[0] + MU) / d0 - MU * (y[0] - MD) / d1,
            y[1] - 2.0 * y[2] - MD * y[1] / d0 - MU * y[1] / d1])

    system = System(4, f)
    x1 = 17.0652165601579625588917206249
    y0 = np.array([0.994, 0.0, 0.0, -2.00158510637908252240537862224])
    y_ref = np.array([0.99399999999999999999999999999522,
                      -2.0684595775698038861452905910833e-22,
                      -8.3707817201963888540981055028368e-22,
                      -2.0015851063790825224053786222387])
    return system, 0.0, y0, x1, None, y_ref


def hairer_wanner_eq1():
    """y' = λ (y - cos x) with λ = -50 (samples.rs:781)."""
    L = -50.0

    def f(x, y, args):
        return L * (y - _cos(x))

    system = System(1, f)
    const = _per_device(jac=np.array([L]))
    system.set_jacobian(([0], [0]), lambda x, y, args: const("jac", y.device))

    def y_fn_x(x, args):
        return np.array([-L * (math.sin(x) - L * math.cos(x)
                               + L * math.exp(L * x)) / (L * L + 1.0)])

    return system, 0.0, np.array([0.0]), None, y_fn_x


def robertson():
    """Stiff chemical kinetics (samples.rs:855)."""
    def f(x, y, args):
        return torch.stack([
            -0.04 * y[0] + 1.0e4 * y[1] * y[2],
            0.04 * y[0] - 1.0e4 * y[1] * y[2] - 3.0e7 * y[1] * y[1],
            3.0e7 * y[1] * y[1]])

    system = System(3, f)
    ii = [0, 0, 0, 1, 1, 1, 2]
    jj = [0, 1, 2, 0, 1, 2, 1]
    const = _per_device(k=np.array([-0.04, 0.04]))

    def jac(x, y, args):
        k = const("k", y.device)
        return torch.stack([
            k[0], 1.0e4 * y[2], 1.0e4 * y[1],
            k[1], -1.0e4 * y[2] - 6.0e7 * y[1], -1.0e4 * y[1],
            6.0e7 * y[1]])

    system.set_jacobian((ii, jj), jac)
    return system, 0.0, np.array([1.0, 0.0, 0.0]), None


def van_der_pol(epsilon: float = 1.0e-6, stationary: bool = False):
    """Van der Pol oscillator, HW-II Eq (1.5') (samples.rs:931)."""
    x0 = 0.0
    y0 = np.array([2.0, -0.6])
    x1 = 2.0
    if stationary:
        A = 2.00861986087484313650940188
        T = 6.6632868593231301896996820305
        y0 = np.array([A, 0.0])
        x1 = T
        eps = 1.0
    else:
        eps = epsilon

    def f(x, y, args):
        return torch.stack([y[1],
                            ((1.0 - y[0] * y[0]) * y[1] - y[0]) / eps])

    system = System(2, f)
    ii = [0, 1, 1]
    jj = [1, 0, 1]

    def jac(x, y, args):
        return torch.stack([
            torch.ones((), dtype=y.dtype, device=y.device),
            (-2.0 * y[0] * y[1] - 1.0) / eps,
            (1.0 - y[0] * y[0]) / eps])

    system.set_jacobian((ii, jj), jac)
    return system, x0, y0, x1, None


def amplifier1t():
    """One-transistor amplifier DAE with singular mass matrix
    (samples.rs:1051; HW-II Eq (1.14) p.377)."""
    ALPHA = 0.99
    GAMMA = 1.0 - ALPHA
    BETA = 1e-6
    A = 0.4
    OM = 200.0 * math.pi
    UB = 6.0
    UF = 0.026
    R = 1000.0
    S = 9000.0
    C1, C2, C3 = 1e-6, 2e-6, 3e-6

    def f(x, y, args):
        ue = A * _sin(OM * x)
        g12 = BETA * (torch.exp((y[1] - y[2]) / UF) - 1.0)
        return torch.stack([
            (y[0] - ue) / R,
            (2.0 * y[1] - UB) / S + GAMMA * g12,
            y[2] / S - g12,
            (y[3] - UB) / S + ALPHA * g12,
            y[4] / S])

    system = System(5, f)
    ii = [0, 1, 1, 2, 2, 3, 3, 3, 4]
    jj = [0, 1, 2, 1, 2, 1, 2, 3, 4]
    const = _per_device(k=np.array([1.0 / R, 1.0 / S]))

    def jac(x, y, args):
        k = const("k", y.device)
        h12 = BETA * torch.exp((y[1] - y[2]) / UF) / UF
        return torch.stack([
            k[0],
            2.0 / S + GAMMA * h12, -GAMMA * h12,
            -h12, 1.0 / S + h12,
            ALPHA * h12, -ALPHA * h12,
            k[1],
            k[1]])

    system.set_jacobian((ii, jj), jac)

    mass = CooMatrix(5, 5, 9)
    mass.put(0, 0, -C1)
    mass.put(0, 1, C1)
    mass.put(1, 0, C1)
    mass.put(1, 1, -C1)
    mass.put(2, 2, -C2)
    mass.put(3, 3, -C3)
    mass.put(3, 4, C3)
    mass.put(4, 3, C3)
    mass.put(4, 4, -C3)
    system.set_mass(mass)
    y0 = np.array([0.0, UB / 2.0, UB / 2.0, UB, 0.0])
    return system, 0.0, y0, None


def kreyszig_eq6_page902():
    """y' = x + y, y(0) = 0 (Kreyszig Eq 6 p.902)."""
    def f(x, y, args):
        return x + y

    system = System(1, f)
    const = _per_device(jac=np.ones(1))
    system.set_jacobian(([0], [0]), lambda x, y, args: const("jac", y.device))
    y_fn_x = lambda x, args: np.array([math.exp(x) - x - 1.0])
    return system, 0.0, np.array([0.0]), None, y_fn_x


def kreyszig_ex4_page920():
    """y'' + 2y' + 101y = 0 as a 2-dim system (Kreyszig Ex 4 p.920)."""
    def f(x, y, args):
        return torch.stack([y[1],
                            -10.0 * y[0] - 11.0 * y[1] + 10.0 * x + 11.0])

    system = System(2, f)
    ii = [0, 1, 1]
    jj = [1, 0, 1]
    const = _per_device(jac=np.array([1.0, -10.0, -11.0]))
    system.set_jacobian((ii, jj), lambda x, y, args: const("jac", y.device))

    def y_fn_x(x, args):
        return np.array([math.exp(-x) + math.exp(-10.0 * x) + x,
                         -math.exp(-x) - 10.0 * math.exp(-10.0 * x) + 1.0])

    return system, 0.0, np.array([2.0, -10.0]), None, y_fn_x
