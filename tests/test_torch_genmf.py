"""GENMF in russell_tpu_torch against russell_tpu's, on the CPU.

The same inputs (made from a seed with numpy) go through both packages:
the symbolic plan (every array of every class and link equal, a
disconnected graph too), the per-class factors of real and complex
systems (planes), log|det|, min|pivot|, n_perturbed and the determinant's
phase, the solves (the port's also on the reference's factors, through
``interop``), AUTO's route to GENMF without a hint (a small Brusselator
Jacobian too), a front wider than the Gauss-Jordan base ``GJ_MAX_M`` (the
recursive Schur split), and GENMF against the port's SPLU. The reference
runs jitted, as its LinSolver runs it; f64 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from russell_tpu.sparse import factor as jfactor, genmf as jgenmf
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch import interop
from russell_tpu_torch.ode import samples as osamples
from russell_tpu_torch.sparse import factor, genmf, samples, splu
from russell_tpu_torch.sparse.enums import Genie

# f64 results whose sums and products run in another order than XLA's
RTOL = 1e-12

CLASS_INTS = ("depth", "e", "r", "n_nodes", "asm_off", "asm_len", "F")
CLASS_ARRAYS = ("elim_var", "pad_diag", "asm_idx")
LINK_ARRAYS = ("parent_slot", "child_slot", "inv", "fwd")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _irregular(n, seed):
    ii, jj, vv = samples.irregular_geometric(n, seed=seed).triplets()
    return n, ii, jj, vv


def _disconnected():
    """Two independent irregular blocks and an isolated diagonal var: the
    nested-dissection tree is a forest."""
    _, i1, j1, v1 = _irregular(90, 5)
    _, i2, j2, v2 = _irregular(70, 6)
    n = 90 + 70 + 1
    return (n, np.concatenate([i1, i2 + 90, [n - 1]]),
            np.concatenate([j1, j2 + 90, [n - 1]]),
            np.concatenate([v1, v2, [3.5]]))


def _complex(vals, seed):
    rng = np.random.default_rng(seed)
    return vals + 0.3j * rng.normal(size=len(vals))


def _dense(n, ii, jj, vv):
    a = np.zeros((n, n), dtype=vv.dtype)
    np.add.at(a, (ii, jj), vv)
    return a


def _assert_plans_equal(jp, tp):
    assert (tp.n, tp.n_uniq, tp.pivot_epsilon, tp.flops) == (
        jp.n, jp.n_uniq, jp.pivot_epsilon, jp.flops)
    assert tp.store_f32_gb == jp.store_f32_gb
    assert tp.stats_dict() == jp.stats_dict()
    np.testing.assert_array_equal(tp.entry_perm, jp.entry_perm)
    np.testing.assert_array_equal(tp.entry_seg, jp.entry_seg)
    assert len(tp.classes) == len(jp.classes)
    for ci, (jc, tc) in enumerate(zip(jp.classes, tp.classes)):
        for k in CLASS_INTS:
            assert getattr(tc, k) == getattr(jc, k), (ci, k)
        for k in CLASS_ARRAYS:
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k),
                                          err_msg=f"class {ci} {k}")
            assert getattr(tc, k).dtype == getattr(jc, k).dtype, (ci, k)
        assert len(tc.links) == len(jc.links), ci
        for jl, tl in zip(jc.links, tc.links):
            assert tl.src == jl.src
            for k in LINK_ARRAYS:
                np.testing.assert_array_equal(getattr(tl, k), getattr(jl, k),
                                              err_msg=f"class {ci} {k}")


@pytest.mark.parametrize("case,leaf", [
    ("irregular300", 24), ("irregular600", 48), ("disconnected", 16),
    ("laplacian12", 16)])
def test_genmf_plan_matches_reference(case, leaf):
    if case.startswith("irregular"):
        n, ii, jj, _ = _irregular(int(case[9:]), seed=3)
    elif case == "disconnected":
        n, ii, jj, _ = _disconnected()
    else:
        ii, jj, _ = samples.laplacian_2d(12).triplets()
        n = 144
    jp = jgenmf.genmf_analyze(n, ii, jj, leaf_target=leaf)
    tp = genmf.genmf_analyze(n, ii, jj, leaf_target=leaf)
    assert len(tp.classes) > 2 and any(c.links for c in tp.classes)
    _assert_plans_equal(jp, tp)
    # interop carries the reference's plan over whole
    _assert_plans_equal(jp, interop.genmf_plan_from(jp))


def _reference(jp, vals, b):
    fac = jax.jit(lambda d: jgenmf.genmf_factorize(jp, d))(vals)
    x = jax.jit(lambda f, v: jgenmf.genmf_solve(jp, f, v))(fac, b)
    return fac, np.asarray(x)


def _assert_factors_close(jf, tf):
    """Per-class factors at RTOL of each class's max over its real and
    imaginary planes; pivot statistics."""
    for ci, (a, b) in enumerate(zip(jf["classes"], tf["classes"])):
        for re, im in (("sir", "sii"), ("lr", "li"), ("br", "bi")):
            pair = [np.asarray(a[k]) for k in (re, im) if a[k] is not None]
            scale = max((np.abs(p).max() for p in pair if p.size),
                        default=0.0)
            for k in (re, im):
                if a[k] is None:
                    assert b[k] is None, (ci, k)
                    continue
                want = np.asarray(a[k])
                got = b[k].numpy()
                assert got.shape == want.shape, (ci, k)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=RTOL * scale,
                                           err_msg=f"class {ci} {k}")
    np.testing.assert_allclose(float(tf["logdet"]), float(jf["logdet"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tf["min_pivot"]),
                               float(jf["min_pivot"]), rtol=RTOL)
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])
    assert float(tf["phase"]) == float(jf["phase"])


# (matrix, leaf, complex): several classes and links; the last has a front
# wider than GJ_MAX_M, which both packages invert by Schur splits
@pytest.mark.parametrize("case,leaf,cplx", [
    ("irregular120", 16, False), ("irregular120", 16, True),
    ("irregular330", 200, False)])
def test_genmf_factor_solve_match_reference(case, leaf, cplx):
    n, ii, jj, vv = _irregular(int(case[9:]), seed=3)
    if cplx:
        vv = _complex(vv, seed=7)
    rng = np.random.default_rng(11)
    b = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0.0)
    jp = jgenmf.genmf_analyze(n, ii, jj, leaf_target=leaf)
    tp = genmf.genmf_analyze(n, ii, jj, leaf_target=leaf)
    if case == "irregular330":
        assert max(c.e for c in tp.classes) > splu.GJ_MAX_M
    jf, jx = _reference(jp, vv, b)
    tf = genmf.genmf_factorize(tp, torch.as_tensor(vv))
    tx = genmf.genmf_solve(tp, tf, torch.as_tensor(b)).numpy()
    _assert_factors_close(jf, tf)
    np.testing.assert_allclose(tx, jx, rtol=RTOL,
                               atol=RTOL * np.abs(jx).max())
    a = _dense(n, ii, jj, vv)
    assert np.abs(a @ tx - b).max() <= 1e-12 * np.abs(b).max()
    # the determinant's phase (the complex one recovered from the stored
    # inverse pivot blocks) against the reference's and numpy's
    jsp = jfactor.SolvePlan(genie=JGenie.GENMF, n=n, rows=ii, cols=jj)
    tsp = factor.SolvePlan(genie=Genie.GENMF, n=n, rows=ii, cols=jj)
    ph = factor.det_phase(tsp, tf)
    np.testing.assert_allclose(ph, jfactor.det_phase(jsp, jf), atol=RTOL)
    sign, logdet = np.linalg.slogdet(a)
    np.testing.assert_allclose(ph, sign, atol=1e-12)
    np.testing.assert_allclose(float(tf["logdet"]), logdet, rtol=1e-12)
    # the port's solve on the reference's factors, and back
    keys = ("classes", "logdet", "phase", "min_pivot", "n_perturbed")
    tf2 = interop.tree_to_torch({k: jf[k] for k in keys}, "cpu")
    tx2 = genmf.genmf_solve(tp, tf2, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(tx2, jx, rtol=RTOL,
                               atol=RTOL * np.abs(jx).max())
    back = interop.tree_to_numpy({k: tf[k] for k in keys})
    jx2 = np.asarray(jax.jit(lambda f, v: jgenmf.genmf_solve(jp, f, v))(
        back, b))
    np.testing.assert_allclose(jx2, tx, rtol=RTOL,
                               atol=RTOL * np.abs(tx).max())


@pytest.mark.parametrize("cplx", [False, True])
def test_genmf_disconnected_graph_solves(cplx):
    # the forest of a disconnected graph (its plan equals the reference's,
    # above): the solve is exact
    n, ii, jj, vv = _disconnected()
    if cplx:
        vv = _complex(vv, seed=9)
    plan = genmf.genmf_analyze(n, ii, jj, leaf_target=16)
    fac = genmf.genmf_factorize(plan, torch.as_tensor(vv))
    x = genmf.genmf_solve(plan, fac, torch.ones(n, dtype=torch.float64))
    a = _dense(n, ii, jj, vv)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, np.ones(n)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(fac["logdet"]),
                               np.linalg.slogdet(a)[1], rtol=1e-12)


def test_auto_routes_to_genmf_without_a_hint():
    # an irregular pattern whose RCM bandwidth exceeds max_block
    n, ii, jj, vv = _irregular(400, seed=8)
    kw = dict(dense_threshold=100, max_block=8)
    jp = jfactor.analyze(n, ii, jj, mixed_precision=False, **kw)
    tp = factor.analyze(n, ii, jj, **kw)
    assert tp.genie == Genie.GENMF and jp.genie == JGenie.GENMF
    assert tp.effective_ordering == jp.effective_ordering == "nd-general"
    assert tp.refine_steps == jp.refine_steps
    assert tp.scaling.value == jp.scaling.value
    _assert_plans_equal(jp.genmf_plan, tp.genmf_plan)
    b = np.cos(np.arange(n))
    fac = factor.numeric_factorize(tp, torch.as_tensor(vv))
    x = factor.factor_solve(tp, fac, torch.as_tensor(b)).numpy()
    a = _dense(n, ii, jj, vv)
    assert np.abs(a @ x - b).max() <= 1e-12 * np.abs(b).max()
    # GENMF against the port's SPLU on the same matrix
    sp = factor.analyze(n, ii, jj, genie=Genie.SPLU)
    sfac = factor.numeric_factorize(sp, torch.as_tensor(vv))
    xs = factor.factor_solve(sp, sfac, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, xs, rtol=1e-12, atol=1e-12 * np.abs(xs).max())
    np.testing.assert_allclose(float(fac["logdet"]), float(sfac["logdet"]),
                               rtol=1e-12)


def test_brusselator_jacobian_without_hint():
    # the flagship matrix WITHOUT its grid hint: AUTO takes GENMF when the
    # band is wider than max_block, and the solve is exact
    npoint = 13
    system, t0, y0, _ = osamples.brusselator_pde(2e-3, npoint)
    ii, jj = (np.asarray(v) for v in system.jac_structure)
    n = system.ndim
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    data = np.concatenate([-jv, np.full(n, 120.0)])
    kw = dict(dense_threshold=100, max_block=8)
    jp = jfactor.analyze(n, rows, cols, mixed_precision=False, **kw)
    tp = factor.analyze(n, rows, cols, **kw)
    assert tp.genie == Genie.GENMF and jp.genie == JGenie.GENMF
    _assert_plans_equal(jp.genmf_plan, tp.genmf_plan)
    fac = factor.numeric_factorize(tp, torch.as_tensor(data))
    b = np.sin(np.arange(n))
    x = factor.factor_solve(tp, fac, torch.as_tensor(b)).numpy()
    a = _dense(n, rows, cols, data)
    assert np.abs(a @ x - b).max() < 1e-9
