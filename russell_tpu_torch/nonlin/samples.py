"""Continuation test problems (reference: russell_nonlin/src/samples.rs).

Counterpart of ``russell_tpu.nonlin.samples``. Each problem's functions
take torch tensors and compute on the device of ``u``; their constant
tables are uploaded to a device once, at its first use. The 2-D Bratu
residual sums ``K u`` per row in entry order (``splu.segment_sum``), not
with an ``index_add_``, whose float atomics on the card would add a row's
terms in any order: two runs give the same bits. The sum is an autograd
``Function`` with forward- and reverse-mode rules and a vmap rule, so
``torch.func.jacfwd`` differentiates the residual as ``jax.jacfwd`` does
the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.nonlin.system import System
from russell_tpu_torch.ode.samples import _per_device
from russell_tpu_torch.sparse.ordering import segment_index
from russell_tpu_torch.sparse.splu import segment_sum

__all__ = ["simple_linear_problem", "two_eq_ref", "one_eq_with_fold_point",
           "circle_ul", "two_eq_nr_prob_1", "bratu_1d_spc", "bratu_2d_fdm",
           "cubic_poly_1", "cubic_poly_2", "singular_initial_state",
           "bspline_problem_1"]


class _RowSum(torch.autograd.Function):
    """Per-row sums of the entry values ``vals`` (dim 0) in entry order
    (``splu.segment_sum`` on ``ordering.segment_index``'s ``order`` and
    ``offsets``; ``rows`` are the entries' rows): linear in ``vals``, so its
    tangent is the sum of the tangents and its gradient a gather."""

    @staticmethod
    def forward(vals, order, offsets, rows):
        return segment_sum(vals, order, offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.order, ctx.offsets, ctx.rows = inputs

    @staticmethod
    def jvp(ctx, dvals, *_):
        return _RowSum.apply(dvals, ctx.order, ctx.offsets, ctx.rows)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None, None

    @staticmethod
    def vmap(info, in_dims, vals, order, offsets, rows):
        # the batch goes last: segment_sum sums along dim 0
        if in_dims[0] is None:
            return _RowSum.apply(vals, order, offsets, rows), None
        return _RowSum.apply(vals.movedim(in_dims[0], -1), order, offsets,
                             rows), -1


def _like(u, vals):
    """The python floats ``vals`` as a tensor of u's dtype and device."""
    return torch.tensor(vals, dtype=u.dtype, device=u.device)


def simple_linear_problem():
    """G = [2u0 + u1 - 2, u0 + 3u1 - 3]; solution independent of lambda
    (samples.rs:28)."""
    def gg(l, u, args):
        return torch.stack([2.0 * u[0] + u[1] - 2.0,
                            u[0] + 3.0 * u[1] - 3.0])

    def jac(l, u, args):
        return _like(u, [2.0, 1.0, 1.0, 3.0]), torch.zeros_like(u)

    system = System(2, gg, jac, structure=([0, 0, 1, 1], [0, 1, 0, 1]))
    u = np.array([0.0, 0.0])
    u_ref = np.array([0.6, 0.8])
    return system, u, 0.0, u_ref


def two_eq_ref():
    """G = [u0^3 + u1 - 1, -u0 + u1^3 + 1] -> (1, 0) (samples.rs:147)."""
    def gg(l, u, args):
        return torch.stack([u[0] ** 3 + u[1] - 1.0, -u[0] + u[1] ** 3 + 1.0])

    def jac(l, u, args):
        one = torch.ones((), dtype=u.dtype, device=u.device)
        return (torch.stack([3.0 * u[0] ** 2, one, -one, 3.0 * u[1] ** 2]),
                torch.zeros_like(u))

    system = System(2, gg, jac, structure=([0, 0, 1, 1], [0, 1, 0, 1]))
    u = np.array([0.5, 0.5])
    u_ref = np.array([1.0, 0.0])
    return system, u, u_ref


def two_eq_nr_prob_1():
    """Singular-Jacobian-at-solution problem (samples.rs:187)."""
    def gg(l, u, args):
        return torch.stack([u[0] ** 2 + u[1] ** 2, u[0] ** 2 - u[1] ** 2])

    def jac(l, u, args):
        return (torch.stack([2.0 * u[0], 2.0 * u[1], 2.0 * u[0],
                             -2.0 * u[1]]),
                torch.zeros_like(u))

    system = System(2, gg, jac, structure=([0, 0, 1, 1], [0, 1, 0, 1]))
    u = np.array([0.0, 1e-5])
    u_ref = np.array([0.0, 0.0])
    return system, u, u_ref


def one_eq_with_fold_point():
    """G = u - lambda exp(u); fold at lambda = 1/e
    (samples.rs:273; Bank & Mittelmann 1990)."""
    def gg(l, u, args):
        return u - l * torch.exp(u)

    def jac(l, u, args):
        return torch.reshape(1.0 - l * torch.exp(u[0]), (1,)), -torch.exp(u)

    system = System(1, gg, jac, structure=([0], [0]))
    lambda_ana = lambda uu: math.exp(-uu) * uu
    return system, np.array([0.0]), 0.0, lambda_ana


def circle_ul(radius: float = 1.0):
    """G = u^2 + lambda^2 - R^2: the unit-circle branch (samples.rs:408)."""
    def gg(l, u, args):
        return u * u + l * l - radius * radius

    def jac(l, u, args):
        return 2.0 * u, _like(u, [2.0 * l])

    system = System(1, gg, jac, structure=([0], [0]))
    u0 = np.array([radius / math.sqrt(2.0)])
    l0 = radius / math.sqrt(2.0)
    return system, u0, l0


def bratu_1d_spc(npoint: int = 20, alpha: float = 0.0):
    """1-D Bratu problem by spectral collocation + SPS partitioning
    (reference: russell_nonlin/tests/test_bratu_problem.rs):

        d2(phi)/dx2 + lambda exp(phi / (1 + alpha phi)) = 0

    on [0, 1] with homogeneous Dirichlet BCs. phi is collocated on a
    Chebyshev-Gauss-Lobatto grid; u = interior values (SPS: the
    prescribed boundary values are zero so the K-check coupling term
    vanishes). G(u, l) = Kbar u + l b(u), Gu = Kbar + l diag(b'),
    Gl = b with b_m = exp(u_m / (1 + alpha u_m)).

    Returns (system, u0, l0, mid) with ``mid`` the interior index of
    the gridpoint nearest x = 1/2 (the profile maximum).
    """
    from russell_tpu_torch.algo.interp_lagrange import InterpLagrange

    interp = InterpLagrange(npoint - 1)
    interp.calc_dd2_matrix()
    # map [-1, 1] -> [0, 1]: d2/dx2 = (dr/dx)^2 d2/dr2 with dr/dx = 2
    kk = 4.0 * interp.get_dd2()
    interior = np.arange(1, npoint - 1)
    const = _per_device(kbar=kk[np.ix_(interior, interior)])
    ndim = npoint - 2
    alpha = float(alpha)

    def bvec(u):
        return torch.exp(u / (1.0 + alpha * u))

    def gg(l, u, args):
        return const("kbar", u.device) @ u + l * bvec(u)

    ii, jj = np.meshgrid(np.arange(ndim), np.arange(ndim), indexing="ij")

    def jac(l, u, args):
        b = bvec(u)
        bp = b / (1.0 + alpha * u) ** 2
        ggu = const("kbar", u.device) + l * torch.diag(bp)
        return ggu.reshape(-1), b

    system = System(ndim, gg, jac, structure=(ii.ravel(), jj.ravel()))
    xi = np.asarray(interp.xx)[interior]
    mid = int(np.argmin(np.abs(xi)))  # r = 0 <-> x = 1/2
    return system, np.zeros(ndim), 0.0, mid


def bratu_2d_fdm(npoint: int = 17, alpha: float = 0.0):
    """2-D Bratu problem on the unit square by the 5-point FDM + SPS
    partitioning (reference: test_bratu_problem.rs, Bolstad & Keller
    oracle lambda_crit = 6.80812442259 at alpha = 0):

        lap(phi) + lambda exp(phi / (1 + alpha phi)) = 0,  phi = 0 on bnd.

    u = interior (unknown) values; G(u, l) = Kbar u + l b(u) with Kbar
    the FDM Laplacian restricted to unknowns (kx = ky = -1 so the
    operator is +lap). Sparse Gu structure = Kbar pattern + diagonal.
    ``Kbar u`` sums each row's terms in entry order (``segment_sum``).

    Returns (system, u0, l0, mid) with ``mid`` the unknown index nearest
    the domain center (the profile maximum).
    """
    from russell_tpu_torch.pde import (EssentialBcs2d, Fdm2d, Grid2d,
                                       NaturalBcs2d)

    ebcs = EssentialBcs2d()
    ebcs.set_homogeneous()
    grid = Grid2d.new_uniform(0.0, 1.0, 0.0, 1.0, npoint, npoint)
    # only Fdm2d's host assembly is used: it solves nothing here
    fdm = Fdm2d(grid, ebcs, NaturalBcs2d(), -1.0, -1.0, device="cpu")
    kbar, _ = fdm.get_matrices_sps(0.0)
    ki, kj, kv = kbar.triplets()
    ki = np.asarray(ki)
    kj = np.asarray(kj)
    ndim = kbar.nrow
    order, offsets = segment_index(ki, ndim)
    const = _per_device(ki=ki, kj=kj, kv=np.asarray(kv), offsets=offsets,
                        **({} if order is None else {"order": order}))
    alpha = float(alpha)

    def bvec(u):
        return torch.exp(u / (1.0 + alpha * u))

    def gg(l, u, args):
        dev = u.device
        ku = _RowSum.apply(const("kv", dev) * u[const("kj", dev)],
                           None if order is None else const("order", dev),
                           const("offsets", dev), const("ki", dev))
        return ku + l * bvec(u)

    ii = np.concatenate([ki, np.arange(ndim)])
    jj = np.concatenate([kj, np.arange(ndim)])

    def jac(l, u, args):
        b = bvec(u)
        bp = b / (1.0 + alpha * u) ** 2
        return torch.cat([const("kv", u.device).to(u.dtype), l * bp]), b

    system = System(ndim, gg, jac, structure=(ii, jj))
    # unknown index nearest the center (grid m = i + j*nx; eq maps)
    eq = fdm.equations
    nx = npoint
    mctr = (nx // 2) + (nx // 2) * nx
    mid = int(eq.e_to_iu[mctr])
    assert mid >= 0
    return system, np.zeros(ndim), 0.0, mid


def cubic_poly_1():
    """u^3 - 2u - 2 = 0 (samples.rs:65): Newton trials that converge
    (u=1), oscillate (u=0), and start at the stationary point
    (u=sqrt(2/3)). Reference root 1.76929235423863."""
    def gg(l, u, args):
        return u * u * u - 2.0 * u - 2.0

    def jac(l, u, args):
        return 3.0 * u * u - 2.0, torch.zeros_like(u)

    system = System(1, gg, jac, structure=([0], [0]))
    u_ok = np.array([1.0])
    u_oscillation = np.array([0.0])
    u_indeterminate = np.array([math.sqrt(2.0 / 3.0)])
    u_reference = np.array([1.76929235423863])
    return system, u_ok, u_oscillation, u_indeterminate, u_reference


def cubic_poly_2():
    """(u - 1)^3 + 0.512 = 0 (samples.rs:106): slow one-sided Newton
    convergence toward u = 0.2."""
    def gg(l, u, args):
        return (u - 1.0) ** 3 + 0.512

    def jac(l, u, args):
        return 3.0 * (u - 1.0) ** 2, torch.zeros_like(u)

    system = System(1, gg, jac, structure=([0], [0]))
    return system, np.array([5.0]), np.array([0.2])


def singular_initial_state(alpha: float, perturbation: float):
    """G = u^alpha - lambda with dG/du singular at u -> 0 for alpha < 1
    (samples.rs:309); lambda_ana(u) = u^alpha."""
    def gg(l, u, args):
        return u ** alpha - l

    def jac(l, u, args):
        return alpha * u ** (alpha - 1.0), -torch.ones_like(u)

    system = System(1, gg, jac, structure=([0], [0]))
    lambda_ana = lambda uu: uu ** alpha
    return system, np.array([perturbation]), 0.0, lambda_ana


def bspline_problem_1(snap_back_delta: float = 1.5):
    """G(u, lambda) = u - C(lambda): follow a 2-D quadratic B-spline curve
    whose control point P3 snaps back by ``snap_back_delta``, creating a
    fold/turning-point structure (samples.rs:348 bspline_problem_1).

    As in the reference package, the host precomputes the exact per-span
    quadratic polynomial coefficients of C(t) from :class:`~russell_tpu_
    torch.algo.misc.Bspline` (degree 2 => each knot span is an exact
    quadratic), and ``gg``/``jac`` evaluate them branch-free with a
    searchsorted span select on u's device.
    """
    from russell_tpu_torch.algo.misc import Bspline

    knots = [0.0, 0.0, 0.0, 0.4, 0.6, 1.0, 1.0, 1.0]
    control = np.array([[0.0, 0.0], [0.5, 1.0], [1.75, 1.0],
                        [2.0 - snap_back_delta, 0.0], [2.5, 0.5]])
    bs = Bspline(2, knots).set_control_points(control)
    spans = [(0.0, 0.4), (0.4, 0.6), (0.6, 1.0)]
    coef = np.zeros((len(spans), 2, 3))  # span x coord x (t^2, t, 1)
    for s, (a, b) in enumerate(spans):
        ts = np.linspace(a, b, 3)
        pts = np.array([bs.calc_point(t) for t in ts])  # (3, 2)
        coef[s] = np.linalg.solve(np.vander(ts, 3), pts).T
    const = _per_device(coef=coef,
                        breaks=np.array([sp[0] for sp in spans[1:]]))

    def _curve_and_deriv(l, u):
        t = torch.clamp(torch.as_tensor(l, dtype=u.dtype, device=u.device),
                        0.0, 1.0)
        s = torch.searchsorted(const("breaks", u.device), t, right=True)
        c = const("coef", u.device)[s]  # (2, 3)
        point = (c[:, 0] * t + c[:, 1]) * t + c[:, 2]
        deriv = 2.0 * c[:, 0] * t + c[:, 1]
        return point, deriv

    def gg(l, u, args):
        point, _ = _curve_and_deriv(l, u)
        return u - point

    def jac(l, u, args):
        _, deriv = _curve_and_deriv(l, u)
        return torch.ones_like(u), -deriv

    system = System(2, gg, jac, structure=([0, 1], [0, 1]))
    curve_ana = lambda t: np.array([float(v) for v in bs.calc_point(t)])
    return system, np.array([0.0, 0.0]), 0.0, curve_ana
