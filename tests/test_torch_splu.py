"""SPLU in russell_tpu_torch against russell_tpu's (the reference).

The same inputs, made from a seed with numpy, go through both packages on
the CPU in f64; the port's two kernel wrappers take their plain PyTorch
versions here (CPU tensors). The kernels themselves are held to those
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from russell_tpu.sparse import samples as jsamples
from russell_tpu.sparse import splu as jsplu
from russell_tpu_torch import interop
from russell_tpu_torch.ode import samples as tsamples
from russell_tpu_torch.sparse import splu as tsplu

torch.set_num_threads(2)

# f64 results summed in another order than XLA's
RTOL, ATOL = 1e-12, 1e-13


def _laplacian(k):
    coo = jsamples.laplacian_2d(k)
    ii, jj, vv = map(np.asarray, coo.triplets())
    return coo.nrow, ii, jj, vv


def _brusselator_k(npoint):
    """Radau5's K pattern (Jacobian + mass diagonal) and γI - J values."""
    system, _, y0, _ = tsamples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    jv = system.jacobian(0.0, torch.as_tensor(y0), None).numpy()
    return (n, np.concatenate([ii, np.arange(n)]),
            np.concatenate([jj, np.arange(n)]),
            np.concatenate([-jv, np.full(n, 40.0)]))


# (name, matrix, block size): laplacian_2d(48) at b = 8 has split diagonal
# (type 0) and panel (type 1) rows besides merged ones; the others merge
# every level into one row
CASES = {
    "lap8": (lambda: _laplacian(8), 32),
    "bru5": (lambda: _brusselator_k(5), 32),
    "lap12": (lambda: _laplacian(12), 32),
    "lap48_b8": (lambda: _laplacian(48), 8),
}


def _values(vv, seed):
    """Unsymmetric, diagonally weighted values on the pattern."""
    rng = np.random.default_rng(seed)
    return vv + 0.1 * rng.standard_normal(len(vv))


def _plans(case, ordering="nd"):
    make, b = CASES[case]
    n, ii, jj, vv = make()
    jp = jsplu.splu_analyze(n, ii, jj, block_size=b, ordering=ordering)
    tp = tsplu.splu_analyze(n, ii, jj, block_size=b, ordering=ordering)
    return n, ii, jj, vv, jp, tp


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(k for k in a if not k.startswith("_")) == \
            sorted(k for k in b if not k.startswith("_")), path
        for k in a:
            if not k.startswith("_"):
                _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("case,ordering", [
    ("lap8", "nd"), ("lap8", "amd"), ("bru5", "nd"), ("bru5", "amd"),
    ("lap48_b8", "nd")])
def test_plan_arrays_equal_reference(case, ordering):
    *_, jp, tp = _plans(case, ordering)
    for name in ("n", "b", "nb", "nblk", "perm", "scatter_idx", "pad_idx",
                 "diag_idx", "pivot_epsilon", "fill_blocks", "lvl_cols",
                 "packed"):
        _assert_tree_equal(getattr(jp, name), getattr(tp, name), name)


def _compare_factor(jf, tf):
    np.testing.assert_allclose(tf["blocks"].numpy(),
                               np.asarray(jf["blocks"]), rtol=RTOL,
                               atol=ATOL)
    for k in ("logdet", "min_pivot", "phase"):
        np.testing.assert_allclose(float(tf[k]), float(jf[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])


@pytest.mark.parametrize("case", ["lap8", "bru5", "lap12", "lap48_b8"])
def test_factorize_multi_matches_reference(case):
    n, ii, jj, vv, jp, tp = _plans(case)
    vr = _values(vv, 1)
    vc = vr + 1j * _values(np.zeros_like(vv), 2)
    jfr, jfc = jsplu.splu_factorize_multi(jp, (jnp.asarray(vr),
                                               jnp.asarray(vc)))
    tfr, tfc = tsplu.splu_factorize_multi(tp, (torch.as_tensor(vr),
                                               torch.as_tensor(vc)))
    assert tfr["blocks"].shape[1] == tp.b ** 2
    assert tfc["blocks"].shape[1] == 4 * tp.b ** 2     # K embedding
    _compare_factor(jfr, tfr)
    _compare_factor(jfc, tfc)
    assert float(tfr["phase"]) in (-1.0, 1.0)

    # (c) the solves of both systems in one pass
    rng = np.random.default_rng(3)
    br = rng.standard_normal(n)
    bc = br + 1j * rng.standard_normal(n)
    jx = jsplu.splu_solve_multi(jp, (jfr, jfc),
                                (jnp.asarray(br), jnp.asarray(bc)))
    tx = tsplu.splu_solve_multi(tp, (tfr, tfc),
                                (torch.as_tensor(br), torch.as_tensor(bc)))
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-12)
    # and the solve is a solve: A x = b
    ax = np.zeros(n)
    np.add.at(ax, ii, vr * tx[0].numpy()[jj])
    np.testing.assert_allclose(ax, br, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("m", [8, 32, 64])
def test_inv_block_clamped_pivots_match_reference(m):
    # lane 0 well conditioned; lanes 1-3 clamp: a zero and a tiny leading
    # pivot, and a singular block (two equal rows)
    rng = np.random.default_rng(m)
    D = rng.standard_normal((4, m, m)) + 4.0 * np.eye(m)
    D[1, 0, 0] = 0.0
    D[2, 0, 0] = 1e-20
    D[3, 1] = D[3, 0]
    delta = 1e-10
    want = jsplu._inv_block(jnp.asarray(D), jnp.asarray(delta))
    got = tsplu._inv_block(torch.as_tensor(D),
                           torch.tensor(delta, dtype=torch.float64))
    g = [t.numpy() for t in got]
    w = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(g[3], w[3])            # n_perturbed
    assert g[3][0] == 0 and (g[3][1:] >= 1).all()
    np.testing.assert_allclose(g[2], w[2], rtol=1e-12)   # min |pivot|
    # the clamped lanes are ill conditioned: beyond m = 32 the Schur
    # splitting's GEMMs (summed in another order) move their values
    live = slice(None) if m <= 32 else slice(0, 1)
    for k, name in ((0, "Dinv"), (1, "logdet"), (4, "phase")):
        np.testing.assert_allclose(g[k][live], w[k][live], rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_gj_inv_complex_matches_reference():
    rng = np.random.default_rng(7)
    D = (rng.standard_normal((4, 8, 8)) + 1j * rng.standard_normal((4, 8, 8))
         + 4.0 * np.eye(8))
    D[0, 0, 0] = 0.0    # clamps; the lane is then ill conditioned
    want = jsplu._gj_inv(jnp.asarray(D), jnp.asarray(1e-12))
    got = tsplu._gj_inv(torch.as_tensor(D),
                        torch.tensor(1e-12, dtype=torch.float64))
    g = [t.numpy() for t in got]
    w = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(g[3], w[3])
    assert list(g[3]) == [1, 0, 0, 0]
    np.testing.assert_allclose(g[2], w[2], rtol=1e-12)
    for k in (0, 1, 4):    # Dinv, logdet, phase of the unclamped lanes
        np.testing.assert_allclose(g[k][1:], w[k][1:], rtol=1e-10,
                                   atol=1e-12)


def _row_blocks(plan, be, seed):
    """Random block storage; block 0 is the zero scratch block the pad
    (and the reference kernel's dummy) pairs point at."""
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((plan.nblk + plan.packed["TL"] + 1,
                                  be * be))
    blocks[0] = 0.0
    return blocks


@pytest.mark.parametrize("cplx", [False, True])
def test_splu_pairs_plain_matches_pallas_interpret(cplx):
    # the reference kernel in interpret mode, on its own augmented pair
    # schedule (tests/test_lin_solver.py:497-524 runs it the same way);
    # interpret mode costs seconds per row, so the K width (2b) checks
    # the row with the most pairs only
    *_, jp, tp = _plans("lap12")
    be = 2 * tp.b if cplx else tp.b
    TL = tp.packed["TL"]
    blocks = _row_blocks(tp, be, 5)
    aug = jsplu._pallas_aug(jp.packed)
    dp = tsplu._device_plan(tp, "cpu")
    npair = [r[3] for r in dp["rows"]]
    rows = [int(np.argmax(npair))] if cplx else range(len(npair))
    for r in rows:
        want = jsplu._pairs_pallas(
            jnp.asarray(blocks), jnp.asarray(aug["pair_l"][r]),
            jnp.asarray(aug["pair_u"][r]), jnp.asarray(aug["pair_seg"][r]),
            jnp.asarray(aug["pair_first"][r]), TL, be, interpret=True)
        # the full padded row: pads (segment TL) must drop out
        got = tsplu.splu_pairs(torch.as_tensor(blocks), dp["pair_l"][r],
                               dp["pair_u"][r], dp["pair_seg"][r],
                               dp["seg_ptr"][r], be)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_gather_rows_plain_matches_pallas_interpret():
    # tests/test_lin_solver.py:535-549: laplacian_2d(12), real and K
    # widths, on the per-lane Dinv gathers of every row (what the port
    # gathers with this kernel)
    *_, jp, tp = _plans("lap12")
    pk = tp.packed
    gather = jax.jit(partial(jsplu._gather_rows, interpret=True))
    for be in (tp.b, 2 * tp.b):
        blocks = _row_blocks(tp, be, 6)
        for r in range(len(pk["t0"])):
            idx = pk["dinv"][r]
            want = gather(jnp.asarray(blocks), jnp.asarray(idx))
            got = tsplu.gather_rows(torch.as_tensor(blocks),
                                    torch.as_tensor(idx))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seg_ptr_brackets_each_lane():
    *_, tp = _plans("lap48_b8")
    pk = tp.packed
    TL = pk["TL"]
    sp = tsplu._seg_ptr(pk["pair_seg"], TL)
    for r, row in enumerate(pk["pair_seg"]):
        for s in np.unique(row[row < TL]):
            lo, hi = sp[r, s], sp[r, s + 1]
            assert (row[lo:hi] == s).all() and hi - lo == (row == s).sum()
        assert sp[r, TL] == (row < TL).sum()


def test_kernel_wrappers_check_their_arguments():
    blocks = torch.zeros((4, 64), dtype=torch.float64)
    i32 = torch.zeros(2, dtype=torch.int32)
    sp = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsplu.splu_pairs(blocks.float(), i32, i32, i32, sp, 8)
    with pytest.raises(ValueError):
        tsplu.splu_pairs(blocks, i32.long(), i32, i32, sp, 8)
    with pytest.raises(ValueError):
        tsplu.splu_pairs(blocks, i32, i32, i32, sp, 4)
    with pytest.raises(ValueError):   # no kernel and no plain version
        tsplu.gather_rows(blocks.to("meta"), i32.to("meta"))
    out = tsplu.gather_rows(blocks, i32)
    assert out.shape == (2, 64)


def test_interop_reference_factor_solved_by_port():
    n, ii, jj, vv, jp, _ = _plans("bru5")
    vr = _values(vv, 11)
    vc = vr * (1.0 + 0.5j)
    jfr, jfc = jsplu.splu_factorize_multi(jp, (jnp.asarray(vr),
                                               jnp.asarray(vc)))
    rng = np.random.default_rng(12)
    br = rng.standard_normal(n)
    bc = br - 2j * rng.standard_normal(n)
    jx = jsplu.splu_solve_multi(jp, (jfr, jfc), (jnp.asarray(br),
                                                 jnp.asarray(bc)))
    tp = interop.splu_plan_from(jp)
    facs = [interop.factor_to_torch({k: np.asarray(v) for k, v in f.items()},
                                   "cpu")
            for f in (jfr, jfc)]
    tx = tsplu.splu_solve_multi(tp, facs, (torch.as_tensor(br),
                                           torch.as_tensor(bc)))
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-13)
    # and back: the port's factorization solved by the reference
    tfr = tsplu.splu_factorize(tp, torch.as_tensor(vr))
    jp2 = jsplu.SpluPlan(**interop.splu_plan_fields(tp))
    jfac = {k: jnp.asarray(v)
            for k, v in interop.factor_to_numpy(tfr).items()}
    jx2 = jsplu.splu_solve(jp2, jfac, jnp.asarray(br))
    np.testing.assert_allclose(np.asarray(jx2), np.asarray(jx[0]),
                               rtol=1e-11, atol=1e-12)
