"""GRIDMF in russell_tpu_torch against russell_tpu's, on the CPU.

The same inputs (made from a seed with numpy) go through both packages:
the symbolic plan (every array equal), the multifrontal factors, the
solves and their pivot statistics, the factor path that AUTO takes with a
grid hint, and Radau5 through it. f64 on the CPU; the reference runs its
plain JAX ops (GRIDMF reaches no Pallas kernel).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, samples as jsamples
from russell_tpu.sparse import factor as jfactor, gridmf as jgridmf
from russell_tpu.sparse.enums import Genie as JGenie, Scaling as JScaling
from russell_tpu.sparse.lin_solver import LinSolParams as JLinSolParams
from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
from russell_tpu_torch.sparse import factor, gridmf
from russell_tpu_torch.sparse import samples as ssamples
from russell_tpu_torch.sparse.enums import Genie, Scaling
from russell_tpu_torch.sparse.lin_solver import LinSolParams

from test_gridmf import _stencil_coo, _stencil_coo_3d

torch.set_num_threads(2)

# f64 results whose sums and products run in another order than XLA's
RTOL = 1e-12

LEVEL_ARRAYS = ("asm_idx", "ghost_diag", "elim_var", "emb")
LEVEL_INTS = ("n_nodes", "ncell_front", "ncell_elim", "s", "asm_off",
              "asm_len", "F", "e", "r")


def _problem(shape, s, cplx, seed=3):
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        n, rows, cols, vals = _stencil_coo(*shape, s, rng)
    else:
        n, rows, cols, vals = _stencil_coo_3d(*shape, s, rng)
    if cplx:
        vals = vals + 0.3j * rng.normal(size=len(vals))
    b = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0.0)
    return n, rows, cols, vals, b


def _plans(n, rows, cols, grid, leaf_cells=4):
    return (jgridmf.gridmf_analyze(n, rows, cols, grid,
                                   leaf_cells=leaf_cells),
            gridmf.gridmf_analyze(n, rows, cols, grid,
                                  leaf_cells=leaf_cells))


def _reference(jp, vals, b):
    """The reference's factors and x, its ops dispatched one by one as its
    own tests run them (under jit XLA fuses products into FMAs, which the
    clamped case's 1/delta amplifies past RTOL)."""
    jf = jgridmf.gridmf_factorize(jp, jnp.asarray(vals))
    return jf, np.asarray(jgridmf.gridmf_solve(jp, jf, jnp.asarray(b)))


# plans shared by the cases of one grid (the reference's eager dispatch
# compiles each op shape once, so cases of one grid share that cost)
_PLANS = {}


def _cached_plans(shape, s):
    if (shape, s) not in _PLANS:
        n, rows, cols, _, _ = _problem(shape, s, False)
        _PLANS[shape, s] = _plans(n, rows, cols, shape + (s,))
    return _PLANS[shape, s]


def _assert_plans_equal(jp, tp):
    assert (tp.n, tuple(tp.dims), tp.s, tp.n_uniq, tp.pivot_epsilon) == (
        jp.n, tuple(jp.dims), jp.s, jp.n_uniq, jp.pivot_epsilon)
    np.testing.assert_array_equal(tp.entry_perm, jp.entry_perm)
    np.testing.assert_array_equal(tp.entry_seg, jp.entry_seg)
    assert len(tp.levels) == len(jp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        for k in LEVEL_INTS:
            assert getattr(tl, k) == getattr(jl, k), k
        for k in LEVEL_ARRAYS:
            a, b = getattr(jl, k), getattr(tl, k)
            if a is None:
                assert b is None, k
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
                assert b.dtype == a.dtype, k


def _assert_fac_close(jf, tf, planes=("sir", "lr", "br")):
    """Per-level factors at RTOL of each level's max; pivot statistics."""
    for d, (a, b) in enumerate(zip(jf["levels"], tf["levels"])):
        for k in planes + ("sii", "li", "bi"):
            if a[k] is None:
                assert b[k] is None, (d, k)
                continue
            want = np.asarray(a[k])
            got = b[k].numpy()
            assert got.shape == want.shape, (d, k)
            if want.size:
                scale = np.max(np.abs(want))
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=RTOL * scale,
                                           err_msg=f"level {d} {k}")
    np.testing.assert_allclose(float(tf["logdet"]), float(jf["logdet"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tf["min_pivot"]),
                               float(jf["min_pivot"]), rtol=RTOL)
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])
    assert float(tf["phase"]) == float(jf["phase"])


# (a) the symbolic plan
@pytest.mark.parametrize("shape,s", [((5, 8), 1), ((5, 8), 2),
                                     ((13, 11), 1), ((13, 11), 2),
                                     ((5, 6, 4), 1), ((5, 6, 4), 2)])
def test_plan_matches_reference(shape, s):
    n, rows, cols, _, _ = _problem(shape, s, False)
    _assert_plans_equal(*_plans(n, rows, cols, shape + (s,)))


# (b) factorize and solve
@pytest.mark.parametrize("shape,s,cplx", [
    ((13, 11), 1, False), ((13, 11), 2, False), ((13, 11), 2, True),
    ((5, 6, 4), 1, False), ((5, 6, 4), 2, True)])
def test_factorize_and_solve_match_reference(shape, s, cplx):
    n, rows, cols, vals, b = _problem(shape, s, cplx)
    jp, tp = _cached_plans(shape, s)
    jf, xj = _reference(jp, vals, b)
    tf = gridmf.gridmf_factorize(tp, torch.as_tensor(vals))
    _assert_fac_close(jf, tf)
    assert int(tf["n_perturbed"]) == 0
    xt = gridmf.gridmf_solve(tp, tf, torch.as_tensor(b)).numpy()
    assert xt.dtype == (np.complex128 if cplx else np.float64)
    np.testing.assert_allclose(xt, xj, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(xj)))
    # and x solves the system
    A = np.zeros((n, n), vals.dtype)
    np.add.at(A, (rows, cols), vals)
    assert np.max(np.abs(A @ xt - b)) < 1e-10 * np.max(np.abs(b))


def test_zeroed_leaf_pivot_is_clamped_as_in_reference():
    shape, s = (13, 11), 2
    n, rows, cols, vals, b = _problem(shape, s, False)
    jp, tp = _cached_plans(shape, s)
    # the first pivot of the first leaf is its first elim var's diagonal,
    # untouched by any update before it: zero it, and it is clamped
    v = int(tp.levels[-1].elim_var[0, 0])
    vals = vals.copy()
    vals[(rows == v) & (cols == v)] = 0.0
    jf, xj = _reference(jp, vals, b)
    tf = gridmf.gridmf_factorize(tp, torch.as_tensor(vals))
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"]) == 1
    assert float(tf["min_pivot"]) == float(jf["min_pivot"]) == 0.0
    _assert_fac_close(jf, tf)
    xt = gridmf.gridmf_solve(tp, tf, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(xj)))


# (c) the factor path that AUTO takes with a grid hint
def test_factor_path_auto_picks_gridmf_and_matches_reference():
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 9)
    ii, jj = system.jac_structure
    n = system.ndim
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    rng = np.random.default_rng(9)
    jv = jv * (1.0 + 0.05 * rng.standard_normal(len(jv)))
    vr = np.concatenate([-jv, np.full(n, 37.0)])
    vc = np.concatenate([-jv + 0j, np.full(n, 27.0 + 31.0j)])
    br = rng.standard_normal(n)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    tp = factor.analyze(n, rows, cols, grid=system.grid, dense_threshold=8)
    jp = jfactor.analyze(n, rows, cols, grid=system.grid, dense_threshold=8)
    assert tp.genie == Genie.GRIDMF and jp.genie == JGenie.GRIDMF
    assert tp.effective_ordering == jp.effective_ordering == "nd-grid"
    assert tp.scaling == Scaling.MAX and jp.scaling == JScaling.MAX
    assert tp.refine_steps == jp.refine_steps
    _assert_plans_equal(jp.gridmf_plan, tp.gridmf_plan)

    tfr, tfc = factor.numeric_factorize_pair(tp, torch.as_tensor(vr),
                                             torch.as_tensor(vc))
    jfr, jfc = jfactor.numeric_factorize_pair(jp, jnp.asarray(vr),
                                              jnp.asarray(vc))
    for jf, tf in ((jfr, tfr), (jfc, tfc)):
        _assert_fac_close(jf, tf)
        np.testing.assert_allclose(tf["rs"].numpy(), np.asarray(jf["rs"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(tf["cs"].numpy(), np.asarray(jf["cs"]),
                                   rtol=RTOL)
    for refine in (0, None):
        xt = factor.factor_solve_pair(tp, tfr, tfc, torch.as_tensor(br),
                                      torch.as_tensor(bc),
                                      refine_steps=refine)
        xj = jfactor.factor_solve_pair(jp, jfr, jfc, jnp.asarray(br),
                                       jnp.asarray(bc), refine_steps=refine)
        for got, want in zip(xt, xj):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-11,
                                       atol=1e-11 * np.max(np.abs(want)))
    # below dense_threshold AUTO takes the reference's DENSE route, with
    # the grid hint too
    assert factor.analyze(n, rows, cols, grid=system.grid).genie == \
        Genie.DENSE
    assert jfactor.analyze(n, rows, cols, grid=system.grid).genie == \
        JGenie.DENSE


# (d) the determinant's sign
def test_determinant_sign_matches_numpy_and_reference():
    coo = ssamples.laplacian_2d(8)
    ii, jj, vv = map(np.asarray, coo.triplets())
    vv = vv.copy()
    vv[ii == 13] *= -1.0
    n = coo.nrow
    A = np.zeros((n, n))
    np.add.at(A, (ii, jj), vv)
    sign, logabs = np.linalg.slogdet(A)
    assert sign == -1.0
    tp = factor.analyze(n, ii, jj, genie=Genie.GRIDMF, grid=(8, 8, 1),
                        scaling=Scaling.NO)
    tf = factor.numeric_factorize(tp, torch.as_tensor(vv))
    jp = jfactor.analyze(n, ii, jj, genie=JGenie.GRIDMF, grid=(8, 8, 1),
                         scaling=JScaling.NO)
    jf = jfactor.numeric_factorize(jp, jnp.asarray(vv))
    assert float(tf["phase"]) == float(jf["phase"]) == sign
    np.testing.assert_allclose(float(tf["logdet"]), logabs, rtol=1e-12)
    np.testing.assert_allclose(float(tf["logdet"]), float(jf["logdet"]),
                               rtol=RTOL)


# (e) a pattern that is not cell-local
def test_non_cell_local_pattern_is_rejected():
    # periodic wrap couples cell 0 to cell nc-1: reach > 1
    nr = nc = 40
    n = nr * nc
    m = np.arange(n)
    rows = np.concatenate([m, m])
    cols = np.concatenate([m, (m + 1) % nc + (m // nc) * nc])
    for analyze in (gridmf.gridmf_analyze, jgridmf.gridmf_analyze):
        with pytest.raises(ValueError, match="cell-local"):
            analyze(n, rows, cols, (nr, nc, 1))
    with pytest.raises(ValueError, match="cell-local"):
        factor.analyze(n, rows, cols, genie=Genie.GRIDMF, grid=(nr, nc, 1))
    with pytest.raises(ValueError, match="grid"):
        factor.analyze(n, rows, cols, genie=Genie.GRIDMF)
    # AUTO above dense_threshold: not GRIDMF, but the reference's other
    # route for the pattern (ported since the LinSolver slice)
    plan = factor.analyze(n, rows, cols, grid=(nr, nc, 1))
    jplan = jfactor.analyze(n, rows, cols, grid=(nr, nc, 1),
                            mixed_precision=False)
    assert plan.genie != Genie.GRIDMF
    assert plan.genie.value == jplan.genie.value


# (f) Radau5 through GRIDMF
def test_radau5_gridmf_brusselator_matches_reference():
    npoint = 5
    jsystem, t0, y0, _ = jsamples.brusselator_pde(2e-3, npoint)
    jparams = JParams(JMethod.RADAU5)
    jparams.newton.lin_sol_params = JLinSolParams(dense_threshold=8)
    jsol = JOdeSolver(jparams, jsystem)
    yj = np.asarray(jsol.solve(y0, t0, 1.0))
    assert jsol.actual.plan.genie == JGenie.GRIDMF

    system, t0, y0t, _ = samples.brusselator_pde(2e-3, npoint)
    params = Params(Method.RADAU5)
    assert params.newton.genie == Genie.AUTO
    params.newton.lin_sol_params = LinSolParams(dense_threshold=8)
    sol = OdeSolver(params, system, "cpu")
    yt = sol.solve(y0t, t0, 1.0).numpy()
    assert sol.actual.plan.genie == Genie.GRIDMF
    keys = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")
    assert {k: getattr(sol.stats(), k) for k in keys} == {
        k: getattr(jsol.stats(), k) for k in keys}
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=0)


def test_flops_and_store_match_reference():
    system = samples.brusselator_pde(2e-3, 17)[0]
    ii, jj = system.jac_structure
    n = system.ndim
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    for leaf in (16, 64):
        jp, tp = _plans(n, rows, cols, system.grid, leaf_cells=leaf)
        assert gridmf.gridmf_flops(tp) == jgridmf.gridmf_flops(jp)
        assert gridmf.gridmf_store_gb(tp, 8) == jgridmf.gridmf_store_gb(jp,
                                                                        8)


def test_leaf_follows_the_device_budget(monkeypatch):
    # the reference's rule at the port's budget: the first leaf whose three
    # f64 planes of factors fit, else the last one whose real plane fits,
    # else out-of-core, which is not ported
    system = samples.brusselator_pde(2e-3, 33)[0]
    ii, jj = system.jac_structure
    n = system.ndim
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    store = {leaf: gridmf.gridmf_store_gb(gridmf.gridmf_analyze(
        n, rows, cols, system.grid, leaf_cells=leaf))
        for leaf in factor.GRIDMF_LEAVES}
    assert store[64] > store[16]
    for budget, leaf in ((3 * store[64], 64), (1.5 * store[16], 16)):
        monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", budget)
        plan = factor.analyze(n, rows, cols, grid=system.grid)
        want = gridmf.gridmf_analyze(n, rows, cols, system.grid,
                                     leaf_cells=leaf)
        assert len(plan.gridmf_plan.levels) == len(want.levels)
        np.testing.assert_array_equal(plan.gridmf_plan.entry_perm,
                                      want.entry_perm)
    monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", 0.5 * store[16])
    with pytest.raises(NotImplementedError, match="out-of-core"):
        factor.analyze(n, rows, cols, grid=system.grid)
