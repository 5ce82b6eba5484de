"""The SPLU path of factor.py in russell_tpu_torch against russell_tpu's.

analyze, equilibration, the real/complex factorization pair and the
paired and single solves with 0 and 2 refinement rounds, on the same
inputs (made from a seed with numpy) through both packages, f64 on the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.sparse import factor as jfactor
from russell_tpu.sparse import samples as jsamples
from russell_tpu.sparse.enums import Genie as JGenie, Scaling as JScaling
from russell_tpu_torch.ode import samples as tsamples
from russell_tpu_torch.sparse import factor as tfactor
from russell_tpu_torch.sparse.enums import Genie, Ordering, Scaling

torch.set_num_threads(2)

# f64 results whose sums run in another order than XLA's
RTOL, ATOL = 1e-11, 1e-13


def _brusselator_k(npoint):
    """Radau5's K pattern (Jacobian + mass diagonal) at y0."""
    system, _, y0, _ = tsamples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    jv = system.jacobian(0.0, torch.as_tensor(y0), None).numpy()
    return (n, np.concatenate([ii, np.arange(n)]),
            np.concatenate([jj, np.arange(n)]), jv)


def _pair_values(jv, n, seed):
    """K_real = γI - J and K_comp = (α+iβ)I - J, with a seeded wobble so
    the scaling has work to do."""
    rng = np.random.default_rng(seed)
    jv = jv * (1.0 + 0.05 * rng.standard_normal(len(jv)))
    vr = np.concatenate([-jv, np.full(n, 37.0)])
    vc = np.concatenate([-jv.astype(np.complex128),
                         np.full(n, 27.0 + 31.0j)])
    return vr, vc


@pytest.fixture(scope="module")
def plans():
    n, ii, jj, jv = _brusselator_k(5)
    jp = jfactor.analyze(n, ii, jj, genie=JGenie.SPLU)
    tp = tfactor.analyze(n, ii, jj, genie=Genie.SPLU)
    return n, ii, jj, jv, jp, tp


def test_analyze_matches_reference(plans):
    n, ii, jj, jv, jp, tp = plans
    assert tp.genie == Genie.SPLU and tp.n == jp.n == n
    assert tp.effective_ordering == jp.effective_ordering
    assert tp.refine_steps == jp.refine_steps
    assert tp.scaling.value == jp.scaling.value
    assert tp.pivot_epsilon == jp.pivot_epsilon
    np.testing.assert_array_equal(tp.rows, jp.rows)
    np.testing.assert_array_equal(tp.cols, jp.cols)
    for name in ("nblk", "perm", "scatter_idx", "pad_idx", "diag_idx"):
        np.testing.assert_array_equal(getattr(tp.splu_plan, name),
                                      getattr(jp.splu_plan, name))
    for k in ("t0", "len", "nd", "pair_l", "pair_u", "pair_seg", "dinv",
              "dloc"):
        np.testing.assert_array_equal(tp.splu_plan.packed[k],
                                      jp.splu_plan.packed[k])


@pytest.mark.parametrize("ordering", [Ordering.METIS, Ordering.AMD,
                                      Ordering.NATURAL])
def test_analyze_orderings_match_reference(ordering):
    coo = jsamples.laplacian_2d(9)
    ii, jj, _ = map(np.asarray, coo.triplets())
    from russell_tpu.sparse.enums import Ordering as JOrdering
    jp = jfactor.analyze(coo.nrow, ii, jj, genie=JGenie.SPLU,
                         ordering=JOrdering(ordering.value))
    tp = tfactor.analyze(coo.nrow, ii, jj, genie=Genie.SPLU,
                         ordering=ordering)
    assert tp.effective_ordering == jp.effective_ordering
    np.testing.assert_array_equal(tp.splu_plan.perm, jp.splu_plan.perm)


@pytest.mark.parametrize("scaling", [Scaling.MAX, Scaling.ROW_COL_ITER,
                                     Scaling.NO])
@pytest.mark.parametrize("cplx", [False, True])
def test_equilibrate_matches_reference(plans, scaling, cplx):
    n, ii, jj, jv, jp, tp = plans
    vr, vc = _pair_values(jv, n, 1)
    v = vc if cplx else vr
    jp2 = dataclasses.replace(jp, scaling=JScaling(scaling.value))
    tp.scaling = scaling
    try:
        want = jfactor._equilibrate(jp2, jnp.asarray(v))
        got = tfactor._equilibrate(tp, torch.as_tensor(v))
    finally:
        tp.scaling = Scaling.MAX
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=0)


def _compare_fac(tf, jf):
    for k in ("blocks", "rs", "cs", "data"):
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("logdet", "min_pivot", "phase"):
        np.testing.assert_allclose(float(tf[k]), float(jf[k]), rtol=RTOL,
                                   err_msg=k)
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])


@pytest.fixture(scope="module")
def pair(plans):
    n, ii, jj, jv, jp, tp = plans
    vr, vc = _pair_values(jv, n, 2)
    jfr, jfc = jfactor.numeric_factorize_pair(jp, jnp.asarray(vr),
                                              jnp.asarray(vc))
    tfr, tfc = tfactor.numeric_factorize_pair(tp, torch.as_tensor(vr),
                                              torch.as_tensor(vc))
    return vr, vc, (jfr, jfc), (tfr, tfc)


def test_numeric_factorize_pair_matches_reference(pair):
    _, _, (jfr, jfc), (tfr, tfc) = pair
    _compare_fac(tfr, jfr)
    _compare_fac(tfc, jfc)


def test_numeric_factorize_single_matches_pair(plans, pair):
    *_, tp = plans
    vr, vc, _, (tfr, tfc) = pair
    for v, f in ((vr, tfr), (vc, tfc)):
        g = tfactor.numeric_factorize(tp, torch.as_tensor(v))
        for k in ("blocks", "logdet", "rs", "cs"):
            torch.testing.assert_close(g[k], f[k], rtol=0, atol=0)


@pytest.mark.parametrize("refine", [0, 2])
def test_factor_solve_pair_matches_reference(plans, pair, refine):
    n, ii, jj, jv, jp, tp = plans
    vr, vc, (jfr, jfc), (tfr, tfc) = pair
    rng = np.random.default_rng(4)
    br = rng.standard_normal(n)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = jfactor.factor_solve_pair(jp, jfr, jfc, jnp.asarray(br),
                                     jnp.asarray(bc), refine_steps=refine)
    got = tfactor.factor_solve_pair(tp, tfr, tfc, torch.as_tensor(br),
                                    torch.as_tensor(bc), refine_steps=refine)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # the real solve through the single-system entry point agrees
    xs = tfactor.factor_solve(tp, tfr, torch.as_tensor(br),
                              refine_steps=refine)
    np.testing.assert_allclose(
        xs.numpy(), np.asarray(jfactor.factor_solve(
            jp, jfr, jnp.asarray(br), refine_steps=refine)),
        rtol=RTOL, atol=ATOL)
    # and the complex system is solved: K_comp x = b
    ax = np.zeros(n, dtype=np.complex128)
    np.add.at(ax, ii, vc * got[1].numpy()[jj])
    np.testing.assert_allclose(ax, bc, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("genie,grid", [
    (Genie.AUTO, None), (Genie.AUTO, (5, 5, 2)), (Genie.GRIDMF, (5, 5, 2)),
    (Genie.GENMF, None), (Genie.DENSE, None), (Genie.BANDED, None)])
def test_other_genies_raise(plans, genie, grid):
    """The genies other than SPLU. GRIDMF plans with its grid hint at any
    n; AUTO at n = 50 <= dense_threshold takes the reference's DENSE route,
    with or without the grid hint, as DENSE itself does (ported since the
    DENSE slice); GENMF and BANDED (ported since the LinSolver slice) plan
    as the reference's do, and none of them raises."""
    n, ii, jj, *_ = plans
    if genie == Genie.GRIDMF:
        plan = tfactor.analyze(n, ii, jj, genie=genie, grid=grid)
        assert plan.genie == Genie.GRIDMF
        assert plan.effective_ordering == "nd-grid"
        return
    plan = tfactor.analyze(n, ii, jj, genie=genie, grid=grid)
    jplan = jfactor.analyze(n, ii, jj, genie=JGenie[genie.name], grid=grid,
                            mixed_precision=False)
    assert plan.genie.value == jplan.genie.value
    assert plan.scaling.value == jplan.scaling.value
    assert plan.refine_steps == jplan.refine_steps
    assert plan.effective_ordering == jplan.effective_ordering
    if genie in (Genie.AUTO, Genie.DENSE):
        assert plan.genie == Genie.DENSE
        assert plan.scaling.value == "no" and plan.refine_steps == 0
    if genie == Genie.GENMF:
        assert plan.genie == Genie.GENMF


def test_auto_above_dense_threshold_routes_as_reference(plans):
    # the reference routes these to BANDED or GENMF, and so does the port:
    # nothing raises or falls back to another route
    n, ii, jj, *_ = plans
    ii2, jj2 = np.r_[ii, 0], np.r_[jj, n - 1]  # not cell-local
    for rows, cols, grid in ((ii, jj, None), (ii2, jj2, (5, 5, 2))):
        for max_block in (4096, 4):
            kw = dict(grid=grid, dense_threshold=8, max_block=max_block)
            plan = tfactor.analyze(n, rows, cols, genie=Genie.AUTO, **kw)
            jplan = jfactor.analyze(n, rows, cols, genie=JGenie.AUTO,
                                    mixed_precision=False, **kw)
            assert plan.genie.value == jplan.genie.value
            assert plan.genie in (Genie.BANDED, Genie.GENMF, Genie.DENSE)
            assert (plan.genie == Genie.GENMF) == (max_block == 4)


def test_mixed_precision_plans_and_pair_match_reference(plans):
    # the reference's refinement rules under mixed precision (its
    # factor.py:170-171, 217, 257, 265, 297, 326, 372) on every genie, the
    # f32 factor dtype, f64 where mixed precision is not asked for (the
    # reference's None is "mixed on a TPU"; the card has f64)
    n, ii, jj, jv, *_ = plans
    lap = jsamples.laplacian_2d(6)
    li, lj = (np.asarray(a) for a in lap.triplets()[:2])
    cases = [(Genie.SPLU, (n, ii, jj), {}), (Genie.DENSE, (n, ii, jj), {}),
             (Genie.BANDED, (n, ii, jj), {}), (Genie.GENMF, (n, ii, jj), {}),
             (Genie.AUTO, (n, ii, jj), {"dense_threshold": 8}),
             (Genie.GRIDMF, (lap.nrow, li, lj), {"grid": (6, 6, 1)})]
    for genie, args, kw in cases:
        for steps in (0, 2, 5):
            tp = tfactor.analyze(*args, genie=genie, refine_steps=steps,
                                 mixed_precision=True, **kw)
            jp = jfactor.analyze(*args, genie=JGenie(genie.value),
                                 refine_steps=steps, mixed_precision=True,
                                 **kw)
            assert tp.mixed32 and jp.mixed32
            assert tp.genie.value == jp.genie.value
            assert tp.refine_steps == jp.refine_steps, (genie, steps)
            assert tfactor._factor_dtype(tp, torch.complex128) \
                == torch.complex64
        assert not tfactor.analyze(*args, genie=genie, **kw).mixed32
    # Radau5's pair under mixed precision: f32 blocks (complex as its f32
    # K embedding), the scaled entries at the input precision, and the
    # plan's three fixed rounds of refinement to the f64 answer
    vr, vc = _pair_values(jv, n, 4)
    tp = tfactor.analyze(n, ii, jj, genie=Genie.SPLU, mixed_precision=True)
    fr, fc = tfactor.numeric_factorize_pair(tp, torch.as_tensor(vr),
                                            torch.as_tensor(vc))
    assert fr["blocks"].dtype == fc["blocks"].dtype == torch.float32
    assert fr["data"].dtype == torch.float64
    assert fc["data"].dtype == torch.complex128
    rng = np.random.default_rng(8)
    br = rng.standard_normal(n)
    bc = br + 1j * rng.standard_normal(n)
    xr, xc = tfactor.factor_solve_pair(tp, fr, fc, torch.as_tensor(br),
                                       torch.as_tensor(bc))
    for vals, b, x in ((vr, br, xr), (vc, bc, xc)):
        A = np.zeros((n, n), dtype=vals.dtype)
        np.add.at(A, (ii, jj), vals)
        xt = np.linalg.solve(A, b)
        assert np.abs(x.numpy() - xt).max() <= 1e-12 * np.abs(xt).max()


@pytest.mark.parametrize("shape", ["real", "complex", "batched", "sorted"])
def test_segment_sum_adds_in_entry_order(shape):
    # the residual's row sums and the SPLU solve's item sums: the bits of a
    # sequential index_add_ in entry order, empty segments zero
    from russell_tpu_torch.sparse.ordering import segment_index
    from russell_tpu_torch.sparse.splu import segment_sum
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 40, 500)
    if shape == "sorted":
        keys = np.sort(keys)
    vals = torch.as_tensor(rng.standard_normal((500, 3))
                           * 10.0 ** rng.integers(-6, 6, (500, 1)))
    if shape == "complex":
        vals = torch.complex(vals, torch.as_tensor(
            rng.standard_normal((500, 3))))
    elif shape == "batched":
        vals = vals.T
    order, offsets = segment_index(keys, 45)
    assert (order is None) == (shape == "sorted")
    if shape == "batched":
        got = segment_sum(vals.movedim(-1, 0),
                          None if order is None else torch.as_tensor(order),
                          torch.as_tensor(offsets)).movedim(0, -1)
        want = torch.zeros((3, 45), dtype=vals.dtype).index_add_(
            -1, torch.as_tensor(keys), vals)
    else:
        got = segment_sum(vals,
                          None if order is None else torch.as_tensor(order),
                          torch.as_tensor(offsets))
        want = torch.zeros((45, 3), dtype=vals.dtype).index_add_(
            0, torch.as_tensor(keys), vals)
    assert torch.equal(got, want)
    assert not bool(got[..., 40:].abs().any() if shape == "batched"
                    else got[40:].abs().any())
