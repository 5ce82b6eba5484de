"""Mixed-precision factorization of russell_tpu_torch against russell_tpu's
(the reference), on the CPU.

``LinSolParams(mixed_precision=True)`` through every genie of the port:
f32 factors (the dtype ``tests/test_lin_solver.py:320-330`` asserts), the
factorization statistics against the reference's own f32 factorization of
the same plan (n_perturbed equal, log|det| and min|pivot| at rtol 1e-5),
and x, refined at f64 by the port's adaptive tiers, within 1e-10 relative
of ``np.linalg.solve``: the reference's jitted adaptive solves compile for
2-17 s each on a CPU, so x is held to the exact solution at the bar the
reference's own tests hold its x to. The
``tests/test_lin_solver.py`` cases: numeric symmetry on laplacian_2d(32)
and its perturbed copy (the reference's host check, which its LinSolver
runs), precision escalation on the kappa ~ 1e9 dense system (the reference
run) and none on laplacian_2d(24) (that test's assertion), the complex128
system at 1e-12 relative, and the out-of-core FCG branch against the
in-core answer. And the f32 plain versions of the three kernels against
the reference's functions: ``_pairs_pallas`` in interpret mode,
``_gather_rows`` (interpret mode) and ``_gj_inv``, all at f32.

The inputs are made from a seed with numpy; the reference runs jitted, as
its LinSolver runs it, its factorizations compiled in threads while this
process runs the port. One intra-op thread (torch's CPU build can deadlock
in batched LAPACK on more).
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from russell_tpu.sparse import factor as jfactor, lin_solver as jlin
from russell_tpu.sparse import splu as jsplu
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch.sparse import (CooMatrix, LinSolParams, LinSolver,
                                      VerifyLinSys, factor, samples, splu)
from russell_tpu_torch.sparse.enums import Genie

X_RTOL = 1e-10          # x against np.linalg.solve, relative to max|x|
STAT_RTOL = 1e-5        # log|det|, min|pivot| against the reference's f32
K = 8                   # laplacian_2d(K): n 64, BANDED nb 8
ROUTES = {               # name: (genie, LinSolParams / analyze keywords)
    "dense": ("DENSE", {}),
    "scan": ("BANDED", {"banded_kernel": "scan"}),
    "bcr": ("BANDED", {"banded_kernel": "bcr"}),
    "splu": ("SPLU", {}),
    "gridmf": ("GRIDMF", {"grid": (K, K, 1)}),
    "genmf": ("GENMF", {}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(k=K, seed=3):
    """laplacian_2d(k)'s pattern with seeded unsymmetric values (a
    dominant diagonal) and its dense matrix."""
    coo = samples.laplacian_2d(k)
    ii, jj, vv = (np.asarray(a) for a in coo.triplets())
    rng = np.random.default_rng(seed)
    vv = vv * (1.0 + 0.2 * rng.random(len(vv)))
    A = np.zeros((coo.nrow, coo.nrow))
    np.add.at(A, (ii, jj), vv)
    return ii, jj, vv, A


def _ref_factor(name):
    """The reference's f32 factorization of the route's plan (jitted):
    factor dtype and statistics."""
    ii, jj, vv, A = _system()
    genie, kw = ROUTES[name]
    plan = jfactor.analyze(A.shape[0], ii, jj,
                           genie=getattr(JGenie, genie),
                           mixed_precision=True, **kw)
    fac = jax.jit(lambda d: jfactor.numeric_factorize(plan, d))(vv)
    key = {"DENSE": "lu", "SPLU": "blocks"}.get(plan.genie.name)
    if plan.genie.name == "BANDED":
        key = "root" if plan.use_bcr else "lus"
    f = fac[key]["lus"] if key == "root" else (
        fac[key] if key else fac["levels" if plan.genie.name == "GRIDMF"
                                 else "classes"][0]["sir"])
    return {"genie": plan.genie.name, "dtype": np.dtype(f.dtype),
            "logdet": float(fac["logdet"]),
            "min_pivot": float(fac["min_pivot"]),
            "n_perturbed": (int(fac["n_perturbed"]) if "n_perturbed" in fac
                            else None)}


@pytest.fixture(scope="module")
def reference():
    """The reference's factorization of every route, compiled in threads
    (XLA compiles without the GIL), the longest first."""
    with ThreadPoolExecutor(3) as pool:
        facs = {name: pool.submit(_ref_factor, name) for name in (
            "genmf", "gridmf", "splu", "bcr", "dense", "scan")}
        return {name: f.result() for name, f in facs.items()}


def _factor_of(sol):
    fac, g = sol.fac, sol.plan.genie
    if g == Genie.DENSE:
        return fac["lu"]
    if g == Genie.BANDED:
        return fac["root"]["lus"] if sol.plan.use_bcr else fac["lus"]
    if g == Genie.SPLU:
        return fac["blocks"]
    return fac["levels" if g == Genie.GRIDMF else "classes"][0]["sir"]


@pytest.mark.parametrize("name", list(ROUTES))
def test_every_genie_factors_in_f32_and_refines_to_f64(reference, name,
                                                       monkeypatch):
    ii, jj, vv, A = _system()
    n = A.shape[0]
    genie, kw = ROUTES[name]
    b = np.sin(np.arange(n) + 1.0)
    x_true = np.linalg.solve(A, b)
    want = reference[name]
    out_of_core = (False, True) if name == "gridmf" else (False,)
    for ooc in out_of_core:
        if ooc:
            monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", 1e-9)
        sol = LinSolver(getattr(Genie, genie), device="cpu")
        params = {k: v for k, v in kw.items() if k != "banded_kernel"}
        if "banded_kernel" in kw:
            # LinSolParams has no kernel choice: AUTO takes the scan at nb
            # 8, so the plan is made here and given to the solver's call
            plan = factor.analyze(n, ii, jj, genie=Genie.BANDED,
                                  mixed_precision=True, **kw)
            monkeypatch.setattr(factor, "analyze",
                                lambda *a, **k: plan)
        sol.factorize(CooMatrix.from_arrays(n, n, ii, jj, vv),
                      LinSolParams(mixed_precision=True, **params))
        assert sol.plan.mixed32 and sol.plan.gridmf_ooc is ooc
        assert sol.plan.genie.name == want["genie"]
        assert _factor_of(sol).dtype == torch.float32
        assert np.dtype(str(_factor_of(sol).dtype).split(".")[1]) \
            == want["dtype"]
        fac = sol.fac
        if want["n_perturbed"] is not None:
            assert int(fac["n_perturbed"]) == want["n_perturbed"]
        np.testing.assert_allclose(float(fac["logdet"]), want["logdet"],
                                   rtol=STAT_RTOL)
        np.testing.assert_allclose(float(fac["min_pivot"]),
                                   want["min_pivot"], rtol=STAT_RTOL)
        x = sol.solve(b)
        assert x.dtype == torch.float64
        assert (np.abs(x.numpy() - x_true).max()
                <= X_RTOL * np.abs(x_true).max())
        assert "precision_escalated" not in sol.stats.output


def test_numeric_symmetry_and_the_fcg_tier():
    # tests/test_lin_solver.py:700-745: laplacian_2d(32) through GRIDMF,
    # symmetric (the FCG tier), and with its lower values scaled by 1.25
    # (FGMRES); the flag is the reference's host check on the same values
    coo = samples.laplacian_2d(32)
    ii, jj, vv = (np.asarray(a) for a in coo.triplets())
    vu = vv.copy()
    vu[ii > jj] *= 1.25
    b = np.ones(coo.nrow)
    for vals in (vv, vu):
        want = jlin._numeric_symmetry(coo.nrow, ii, jj, vals)
        m = CooMatrix.from_arrays(coo.nrow, coo.nrow, ii, jj, vals)
        sol = LinSolver(Genie.GRIDMF, device="cpu")
        sol.factorize(m, LinSolParams(grid=(32, 32, 1), mixed_precision=True))
        assert sol.plan.symmetric_values is want is (vals is vv)
        x = sol.solve(b).numpy()
        A = m.as_dense()
        r = np.abs(A @ x - b).max() / (np.abs(A).sum(1).max()
                                      * np.abs(x).max())
        assert r < 1e-14
        assert np.abs(x - np.linalg.solve(A, b)).max() <= X_RTOL * \
            np.abs(x).max()
        assert "precision_escalated" not in sol.stats.output


def test_fcg_and_fgmres_tiers_converge():
    # where plain refinement stalls on f32 factors, the Krylov tiers carry
    # the solve to the f64 answer without escalating: flexible CG on a
    # symmetric system of condition 3e7, FGMRES on an unsymmetric one of
    # condition 3e8 (n 60, dense storage, AUTO -> DENSE)
    n = 60
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ii, jj = np.nonzero(np.ones((n, n)))
    b = np.ones(n)
    for kappa, right, tier in ((3e7, q, "cg"), (3e8, q2, "fgmres")):
        A = (q * np.logspace(0, np.log10(kappa), n)) @ right.T
        if tier == "cg":
            A = 0.5 * (A + A.T)
        coo = CooMatrix.from_arrays(n, n, ii, jj, A[ii, jj])
        sol = LinSolver(Genie.AUTO, device="cpu")
        sol.factorize(coo, LinSolParams(mixed_precision=True))
        assert sol.plan.symmetric_values is (tier == "cg")
        x = sol.solve(b)
        rounds = factor.factor_solve.refinement
        assert rounds[tier] >= 1 and rounds["w"] < 1e-13, rounds
        assert "precision_escalated" not in sol.stats.output
        assert VerifyLinSys.from_system(coo, x, b).relative_error < 1e-10


def test_a_batch_refines_each_lane_as_its_single_solve():
    # factor_solve_batch under mixed precision: each lane's tiers end with
    # its own tests (symmetric lanes of condition 3e7 (FCG), 1e3 (IR) and
    # 3e8 (FCG then FGMRES)), so each lane's x is its single solve's
    n = 60
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ii, jj = np.nonzero(np.ones((n, n)))
    mats = []
    for kappa in (3e7, 1e3, 3e8):
        A = (q * np.logspace(0, np.log10(kappa), n)) @ q.T
        mats.append(0.5 * (A + A.T))
    V = torch.as_tensor(np.stack([A[ii, jj] for A in mats]))
    b = torch.ones((3, n), dtype=torch.float64)
    plan = factor.analyze(n, ii, jj, genie=Genie.DENSE, mixed_precision=True)
    plan.symmetric_values = True
    X = factor.factor_solve_batch(plan, V, b)
    assert factor.factor_solve.refinement["fgmres"] == 1
    for lane in range(3):
        x = factor.factor_solve(plan, factor.numeric_factorize(plan, V[lane]),
                                b[lane])
        torch.testing.assert_close(X[lane], x, rtol=0,
                                   atol=1e-10 * float(x.abs().max()))


def _escalating():
    """tests/test_lin_solver.py:670-687: n 60, kappa 1e9, dense storage."""
    n = 60
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (q * np.logspace(0, 9, n)) @ q.T
    ii, jj = np.nonzero(np.ones((n, n)))
    return (n, n, ii, jj, A[ii, jj]), np.ones(n), A


def test_precision_escalation_as_the_reference():
    # kappa 1e9 makes f32 factors useless as a preconditioner: the
    # reference escalates once (its test asserts True there, and none on
    # laplacian_2d(24) with f32 factors that suffice), and so must the port
    m, b, A = _escalating()
    sol = LinSolver(Genie.AUTO, device="cpu")
    coo = CooMatrix.from_arrays(*m)
    sol.factorize(coo, LinSolParams(mixed_precision=True))
    assert sol.plan.genie == Genie.DENSE and sol.plan.mixed32
    x = sol.solve(b)
    assert sol.stats.output.get("precision_escalated") is True
    assert not sol.plan.mixed32 and sol.fac["lu"].dtype == torch.float64
    assert VerifyLinSys.from_system(coo, x, b).relative_error < 1e-10
    # the next solve keeps the full-precision factors: no second escalation
    fac = sol.fac
    x2 = sol.solve(np.arange(1.0, 61.0))
    assert sol.fac is fac and torch.isfinite(x2).all()
    coo = samples.laplacian_2d(24)
    sol = LinSolver(Genie.GRIDMF, device="cpu")
    sol.factorize(coo, LinSolParams(grid=(24, 24, 1), mixed_precision=True))
    sol.solve(np.ones(coo.nrow))
    assert "precision_escalated" not in sol.stats.output


def test_complex128_system_refines_to_1e12():
    # tests/test_lin_solver.py:817-850: AUTO (DENSE), complex64 factors,
    # the refinement in complex128 against complex128 entries
    n = 80
    rng = np.random.default_rng(7)
    A = np.zeros((n, n), dtype=np.complex128)
    for k in range(n):
        A[k, k] = 4.0 + rng.normal() + 1j * rng.normal()
    for _ in range(4 * n):
        i, j = rng.integers(0, n, size=2)
        A[i, j] += 0.3 * (rng.normal() + 1j * rng.normal())
    ii, jj = np.nonzero(A != 0)
    sol = LinSolver(Genie.AUTO, device="cpu")
    sol.factorize(CooMatrix.from_arrays(n, n, ii, jj, A[ii, jj]),
                  LinSolParams(mixed_precision=True))
    assert sol.fac["lu"].dtype == torch.complex64
    assert sol.fac["data"].dtype == torch.complex128
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    x = sol.solve(b).numpy()
    assert x.dtype == np.complex128
    xt = np.linalg.solve(A, b)
    assert np.abs(x - xt).max() / np.abs(xt).max() < 1e-12
    br = rng.normal(size=n)       # a real right-hand side, the same route
    xr = sol.solve(br).numpy()
    assert np.abs(xr - np.linalg.solve(A, br)).max() / np.abs(xr).max() \
        < 1e-12
    xr2, xi2 = sol.solve_planes(b.real, b.imag)
    np.testing.assert_array_equal(xr2.numpy() + 1j * xi2.numpy(), x)


def test_out_of_core_fcg_equals_in_core(monkeypatch):
    # tests/test_lin_solver.py:748-760: the FCG tier on host-held factors
    coo = samples.laplacian_2d(24)
    b = np.sin(np.arange(coo.nrow))
    xs = {}
    for budget in (factor.GRIDMF_BUDGET_GB, 1e-9):
        monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", budget)
        sol = LinSolver(Genie.GRIDMF, device="cpu")
        sol.factorize(coo, LinSolParams(grid=(24, 24, 1),
                                        mixed_precision=True))
        assert sol.plan.gridmf_ooc is (budget == 1e-9)
        assert sol.plan.symmetric_values
        xs[sol.plan.gridmf_ooc] = sol.solve(b).numpy()
        assert factor.factor_solve.refinement["w"] < 1e-14
    x_true = np.linalg.solve(coo.as_dense(), b)
    for x in xs.values():
        assert np.abs(x - x_true).max() <= X_RTOL * np.abs(x_true).max()
    np.testing.assert_allclose(xs[True], xs[False], rtol=0,
                               atol=1e-12 * np.abs(x_true).max())


def test_f32_plain_kernels_match_the_reference():
    # rows 4-6 of PERF.md's table at f32: splu_pairs (widened to f64 and
    # rounded once) against _pairs_pallas in interpret mode (f32 sums), the
    # row gather exactly, and the clamped Gauss-Jordan inverse in f32
    coo = samples.laplacian_2d(8)
    ii, jj, _ = (np.asarray(a) for a in coo.triplets())
    tp = splu.splu_analyze(coo.nrow, ii, jj, block_size=8, ordering="nd")
    be, TL = tp.b, tp.packed["TL"]
    rng = np.random.default_rng(19)
    blocks = rng.standard_normal((tp.nblk + TL + 1, be * be)).astype(
        np.float32)
    blocks[0] = 0.0
    dp = splu._device_plan(tp, "cpu")
    r = int(np.argmax([row[3] for row in dp["rows"]]))
    ln, npair = dp["rows"][r][1], dp["rows"][r][3]
    pl, pu, ps = (dp[k][r, :npair].numpy() for k in ("pair_l", "pair_u",
                                                       "pair_seg"))
    # the reference kernel on the row's ln live lanes (its grid steps the
    # TL-lane schedule of _pallas_aug one by one): a zeroing dummy pair
    # (l = u = 0, the zero block) before each lane's pairs
    o = np.argsort(np.r_[np.arange(ln), ps], kind="stable")
    aug = [np.r_[z, a][o].astype(np.int32) for z, a in (
        (np.zeros(ln), pl), (np.zeros(ln), pu), (np.arange(ln), ps),
        (np.ones(ln), np.zeros(npair)))]
    want = np.asarray(jsplu._pairs_pallas(
        jnp.asarray(blocks), *map(jnp.asarray, aug), ln, be, interpret=True))
    got = splu.splu_pairs(torch.as_tensor(blocks), dp["pair_l"][r],
                          dp["pair_u"][r], dp["pair_seg"][r], dp["work"][r],
                          ln, be)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the row gather: 64 rows of 1,024 floats, a multiple of the Pallas
    # kernel's chunk
    rows = rng.standard_normal((40, 1024)).astype(np.float32)
    idx = rng.integers(0, 40, 64).astype(np.int32)
    want = jax.jit(partial(jsplu._gather_rows, interpret=True))(
        jnp.asarray(rows), jnp.asarray(idx))
    got = splu.gather_rows(torch.as_tensor(rows), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the inverse: lane 0 meets a zero pivot at step 0, lane 2 at its last
    w, m = 4, 12
    D = rng.standard_normal((w, m, m)) + 2.0 * m * np.eye(m)
    D[0, 0, 0] = 0.0
    D[2, -1, :] = 0.0
    D[2, :, -1] = 0.0
    D = D.astype(np.float32)
    delta = np.float32(1e-6)
    want = [np.asarray(t) for t in jax.jit(jsplu._gj_inv)(
        jnp.asarray(D), jnp.asarray(delta))]
    got = [t.numpy() for t in splu._gj_inv(torch.as_tensor(D),
                                           torch.tensor(delta))]
    assert got[0].dtype == want[0].dtype == np.float32
    # the clamped lanes' inverses are f32 cancellations of 1/delta-sized
    # rows: held on the unclamped lanes, as tests/test_torch_gj_inv.py does
    for k in (0, 1, 4):
        np.testing.assert_allclose(got[k][[1, 3]], want[k][[1, 3]],
                                   rtol=1e-5, atol=1e-7)
    for k in (2, 3):
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got[3]) == [1, 0, 1, 0]
