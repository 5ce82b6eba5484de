"""The BANDED path of russell_tpu_torch against russell_tpu's, on the CPU.

RCM ordering and bandwidth, the BANDED plan (every array equal), and the
sequential-scan and block-cyclic-reduction factorizations and solves of
real and complex systems, with the static pivot perturbation forced once:
x, log|det|, min|pivot|, n_perturbed and the determinant's phase against
the reference's on the same inputs (made from a seed with numpy). The
reference runs jitted, as its LinSolver runs it; f64 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from russell_tpu.sparse import factor as jfactor
from russell_tpu.sparse import ordering as jordering
from russell_tpu.sparse.enums import Genie as JGenie, Ordering as JOrdering
from russell_tpu_torch import interop
from russell_tpu_torch.sparse import factor, ordering, samples
from russell_tpu_torch.sparse.enums import Genie, Ordering

# f64 results whose sums and products run in another order than XLA's
RTOL = 1e-12

PLAN_ARRAYS = ("perm", "flat_idx", "pad_idx")
PLAN_FIELDS = ("genie", "n", "block_k", "nb", "use_bcr",
               "effective_ordering", "refine_steps", "pivot_epsilon")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls (lu_factor_ex, lu_solve) run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded_coo(n, bw, seed, shuffle=False):
    """Unsymmetric, diagonally dominant banded pattern (entries in random
    order, a few duplicated); ``shuffle`` relabels the unknowns so that RCM
    has a band to find."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), 2 * bw + 1)
    j = i + np.tile(np.arange(-bw, bw + 1), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    v = rng.normal(size=len(i)) * 0.5
    v[i == j] = 4.0 + 2 * bw + rng.random(n)
    dup = rng.choice(len(i), size=len(i) // 10, replace=False)
    i = np.concatenate([i, i[dup]])
    j = np.concatenate([j, j[dup]])
    v = np.concatenate([v, 0.1 * rng.normal(size=len(dup))])
    order = rng.permutation(len(i))
    i, j, v = i[order], j[order], v[order]
    if shuffle:
        p = rng.permutation(n)
        i, j = p[i], p[j]
    return n, i.astype(np.int64), j.astype(np.int64), v


def _laplacian(npoint):
    ii, jj, vv = samples.laplacian_2d(npoint).triplets()
    return npoint * npoint, ii, jj, vv


def _complex(vals, seed):
    rng = np.random.default_rng(seed)
    return vals + 0.3j * rng.normal(size=len(vals))


def _dense(n, ii, jj, vv):
    a = np.zeros((n, n), dtype=vv.dtype)
    np.add.at(a, (ii, jj), vv)
    return a


def _plans(n, ii, jj, genie="auto", **kw):
    jp = jfactor.analyze(n, ii, jj, genie=JGenie(genie),
                         mixed_precision=False, **kw)
    tp = factor.analyze(n, ii, jj, genie=Genie(genie), **kw)
    return jp, tp


def _reference(jp, vals, b):
    fac = jax.jit(lambda d: jfactor.numeric_factorize(jp, d))(vals)
    x = jax.jit(lambda f, v: jfactor.factor_solve(jp, f, v))(fac, b)
    return fac, np.asarray(x)


def _assert_matches(jp, jf, jx, tp, tf, tx, mp_atol=0.0):
    np.testing.assert_allclose(tx, jx, rtol=RTOL, atol=RTOL * np.abs(jx).max())
    np.testing.assert_allclose(float(tf["logdet"]), float(jf["logdet"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tf["min_pivot"]),
                               float(jf["min_pivot"]), rtol=RTOL,
                               atol=mp_atol)
    assert ("n_perturbed" in tf) == ("n_perturbed" in jf)
    if "n_perturbed" in jf:
        assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])
    np.testing.assert_allclose(factor.det_phase(tp, tf),
                               jfactor.det_phase(jp, jf), rtol=0,
                               atol=RTOL)


@pytest.mark.parametrize("case", ["laplacian", "shuffled", "irregular"])
def test_rcm_and_bandwidth_match_reference(case):
    if case == "laplacian":
        n, ii, jj, _ = _laplacian(11)
    elif case == "shuffled":
        n, ii, jj, _ = _banded_coo(90, 3, seed=1, shuffle=True)
    else:
        ii, jj, _ = samples.irregular_geometric(300, seed=4).triplets()
        n = 300
    perm = ordering.rcm_ordering(n, ii, jj)
    np.testing.assert_array_equal(perm, jordering.rcm_ordering(n, ii, jj))
    assert sorted(perm.tolist()) == list(range(n))
    for p in (None, perm):
        assert (ordering.bandwidth(ii, jj, p)
                == jordering.bandwidth(ii, jj, p))
    if case == "shuffled":
        assert ordering.bandwidth(ii, jj, perm) < ordering.bandwidth(ii, jj)


@pytest.mark.parametrize("case,kw", [
    ("lap12", {}), ("lap20", {"banded_kernel": "bcr"}),
    ("band300", {}), ("band300", {"banded_kernel": "scan"}),
    ("band300", {"ordering": "natural"}), ("shuffled", {})])
def test_banded_plan_matches_reference(case, kw):
    if case.startswith("lap"):
        n, ii, jj, _ = _laplacian(int(case[3:]))
    elif case == "band300":
        n, ii, jj, _ = _banded_coo(300, 3, seed=2)
    else:
        n, ii, jj, _ = _banded_coo(120, 2, seed=3, shuffle=True)
    kw = dict(kw)
    jkw = dict(kw)
    if "ordering" in kw:
        jkw["ordering"] = JOrdering(kw["ordering"])
        kw["ordering"] = Ordering(kw["ordering"])
    jp = jfactor.analyze(n, ii, jj, genie=JGenie.BANDED,
                         mixed_precision=False, **jkw)
    tp = factor.analyze(n, ii, jj, genie=Genie.BANDED, **kw)
    for f in PLAN_FIELDS:
        want = getattr(jp, f)
        got = getattr(tp, f)
        assert (got.value if f == "genie" else got) == (
            want.value if f == "genie" else want), f
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
        assert getattr(tp, f).dtype == getattr(jp, f).dtype, f
    assert tp.n_pad == jp.n_pad


def test_banded_auto_routes_as_reference():
    # nb >= 32 blocks: AUTO takes BANDED with cyclic reduction
    n, ii, jj, _ = _banded_coo(300, 3, seed=2)
    jp, tp = _plans(n, ii, jj, dense_threshold=100)
    assert tp.genie == Genie.BANDED and jp.genie == JGenie.BANDED
    assert tp.use_bcr and jp.use_bcr and tp.nb == jp.nb == 38
    # under 2 blocks the band is DENSE, in both packages
    n, ii, jj, _ = _banded_coo(7, 1, seed=5)
    jp, tp = _plans(n, ii, jj, genie="banded")
    assert tp.genie == Genie.DENSE and jp.genie == JGenie.DENSE
    assert tp.refine_steps == jp.refine_steps == 0


# (matrix, kernel, complex): each kernel on both sides of 32 blocks, real
# and complex
@pytest.mark.parametrize("case,kernel,cplx", [
    ("lap12", "scan", False), ("lap12", "bcr", True),
    ("band300", "bcr", False), ("band300", "scan", True)])
def test_banded_factor_solve_match_reference(case, kernel, cplx):
    if case == "lap12":
        n, ii, jj, vv = _laplacian(12)
    else:
        n, ii, jj, vv = _banded_coo(300, 3, seed=2)
    if cplx:
        vv = _complex(vv, seed=7)
    rng = np.random.default_rng(11)
    b = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0.0)
    jp = jfactor.analyze(n, ii, jj, genie=JGenie.BANDED,
                         mixed_precision=False, banded_kernel=kernel)
    tp = factor.analyze(n, ii, jj, genie=Genie.BANDED, banded_kernel=kernel)
    assert tp.use_bcr == (kernel == "bcr")
    assert tp.nb == (9 if case == "lap12" else 38)
    jf, jx = _reference(jp, vv, b)
    tf = factor.numeric_factorize(tp, torch.as_tensor(vv))
    tx = factor.factor_solve(tp, tf, torch.as_tensor(b)).numpy()
    _assert_matches(jp, jf, jx, tp, tf, tx)
    a = _dense(n, ii, jj, vv)
    assert np.abs(a @ tx - b).max() <= 1e-12 * np.abs(b).max()
    sign, logdet = np.linalg.slogdet(a)
    log_scale = float(torch.log(tf["rs"]).sum() + torch.log(tf["cs"]).sum())
    np.testing.assert_allclose(float(tf["logdet"]) - log_scale, logdet,
                               rtol=1e-12)
    np.testing.assert_allclose(factor.det_phase(tp, tf), sign, atol=1e-12)
    # the port's solve on the reference's factors, through interop
    keep = [k for k in jf if k != "data"]
    tf2 = interop.tree_to_torch({k: jf[k] for k in keep}, "cpu")
    tf2["data"] = torch.as_tensor(np.array(jf["data"]))
    tx2 = factor.factor_solve(tp, tf2, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(tx2, jx, rtol=RTOL,
                               atol=RTOL * np.abs(jx).max())
    back = interop.tree_to_numpy({k: tf[k] for k in keep})
    lus = back["levels"][0]["lus"] if kernel == "bcr" else back["lus"]
    assert lus.shape == (np.asarray(jf["levels"][0]["lus"]) if kernel == "bcr"
                         else np.asarray(jf["lus"])).shape


def test_static_pivot_redo_matches_reference():
    # a singular leading 8 x 8 block (all ones): its LU pivots vanish and
    # the block is factorized again as S + delta I, in both packages
    n, ii, jj, vv = _banded_coo(64, 1, seed=6)
    blk = np.arange(8)
    bi, bj = np.meshgrid(blk, blk, indexing="ij")
    ii = np.concatenate([ii, bi.ravel()])
    jj = np.concatenate([jj, bj.ravel()])
    keep = ~((ii < 8) & (jj < 8))
    keep[-64:] = True
    ii, jj = ii[keep], jj[keep]
    vv = np.concatenate([vv, np.ones(64)])[keep]
    b = np.linspace(1.0, 2.0, n)
    jp = jfactor.analyze(n, ii, jj, genie=JGenie.BANDED,
                         mixed_precision=False, banded_kernel="scan")
    tp = factor.analyze(n, ii, jj, genie=Genie.BANDED, banded_kernel="scan")
    jf, jx = _reference(jp, vv, b)
    tf = factor.numeric_factorize(tp, torch.as_tensor(vv))
    tx = factor.factor_solve(tp, tf, torch.as_tensor(b)).numpy()
    assert int(tf["n_perturbed"]) >= 1
    # the smallest pivot is a perturbed one, delta plus rounding of the
    # scaled entries (max 1): held at RTOL of that scale
    _assert_matches(jp, jf, jx, tp, tf, tx, mp_atol=RTOL)
