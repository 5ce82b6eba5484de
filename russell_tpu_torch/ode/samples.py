"""ODE test problems of this slice (reference: russell_ode/src/samples.rs).

Counterpart of ``russell_tpu.ode.samples`` for the 2-D Brusselator PDE and
van der Pol. ``f`` and ``jac`` take torch tensors and compute on the
device of ``y``; their index and coefficient tables are uploaded to a
device once, at its first use. The arithmetic follows the reference
package's operation by operation, so both give the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.ode.system import System

__all__ = ["brusselator_pde", "van_der_pol"]


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
        if second_book and t >= 1.1:
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
