"""LinSolver of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_lin_solver.py`` is the checklist: every case there that
needs neither mixed precision, Pallas interpret mode nor the reference's
data files runs through the reference's LinSolver and the port's on the
same inputs (made from a seed with numpy): x, the determinant (mantissa,
exponent and complex phase) on the DENSE, BANDED, SPLU, GRIDMF and GENMF
routes, the StatsLinSol fields that do not name the platform, the error
analysis with the condition numbers, the structure-change, rectangular,
singular and solve-before-factorize errors, mixed precision's f32 factors
(held to the reference in tests/test_torch_mixed.py), and the
solve_matrix_market CLI's JSON on a file written here. f64 on the
CPU; the reference runs jitted, as its LinSolver does.
"""

import json

import numpy as np
import pytest
import torch

from russell_tpu.bin import solve_matrix_market as jcli
from russell_tpu.sparse import CooMatrix as JCoo, LinSolParams as JParams
from russell_tpu.sparse import LinSolver as JLinSolver
from russell_tpu.sparse import lin_solver as jlin_solver
from russell_tpu.sparse.enums import Genie as JGenie, Sym as JSym
from russell_tpu_torch.bin import solve_matrix_market as cli
from russell_tpu_torch.sparse import (CooMatrix, LinSolParams, LinSolver,
                                      VerifyLinSys, factor, lin_solver,
                                      samples, write_matrix_market)
from russell_tpu_torch.sparse.enums import Genie, Sym

# f64 results whose sums and products run in another order than XLA's
RTOL = 1e-12

OUTPUT_KEYS = ("effective_ordering", "effective_scaling")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(name):
    coo = getattr(samples, name)("cpu")[0]
    return coo.triplets() + (coo.nrow, coo.sym)


def _banded(n=200, bw=3, seed=0):
    """Diagonally dominant banded system (tests/test_lin_solver.py)."""
    rng = np.random.default_rng(seed)
    ii, jj, vv = [], [], []
    for i in range(n):
        ii.append(i); jj.append(i); vv.append(10.0 + rng.random())
        for d in range(1, bw + 1):
            if i + d < n:
                ii += [i, i + d]
                jj += [i + d, i]
                vv += list(rng.standard_normal(2) * 0.5)
    return np.array(ii), np.array(jj), np.array(vv), n, Sym.NO


def _random_complex(n=18, seed=7):
    """A complex matrix with a dominant diagonal and duplicate entries
    (the reference's SPLU complex-phase case)."""
    rng = np.random.default_rng(seed)
    ii = list(range(n))
    jj = list(range(n))
    vv = [complex(3.0 + rng.normal(), rng.normal()) for _ in range(n)]
    for _ in range(60):
        i, j = rng.integers(0, n, 2)
        ii.append(int(i)); jj.append(int(j))
        vv.append(complex(rng.normal(), rng.normal()))
    return np.array(ii), np.array(jj), np.array(vv), n, Sym.NO


def _matrices(ii, jj, vv, n, sym):
    jsym = JSym[sym.name]
    return (JCoo.from_arrays(n, n, ii, jj, vv, jsym),
            CooMatrix.from_arrays(n, n, ii, jj, vv, sym))


# case: (matrix, genie, LinSolParams keywords, complex values)
CASES = {
    "dense_tiny": (lambda: _sample("tiny_1x1"), "auto", {}),
    "dense_umfpack": (lambda: _sample("umfpack_unsymmetric_5x5"), "auto", {}),
    "dense_mkl": (lambda: _sample("mkl_unsymmetric_5x5"), "dense", {}),
    "lower_pd": (lambda: _sample("mkl_positive_definite_5x5_lower"),
                 "auto", {}),
    "lower_sym": (lambda: _sample("lower_symmetric_5x5"), "auto", {}),
    "upper_sym": (lambda: _sample("mkl_symmetric_5x5_upper"), "auto", {}),
    "complex_dense": (lambda: _sample("umfpack_complex_unsymmetric_5x5"),
                      "auto", {}),
    "complex_sym": (lambda: _sample("complex_symmetric_3x3_lower"), "auto",
                    {}),
    "banded": (_banded, "banded", {}),
    "banded_auto": (_banded, "auto", {"dense_threshold": 100}),
    "banded_complex": (lambda: _complexify(_banded(n=120)), "banded", {}),
    "splu": (lambda: _lap(8), "splu", {"compute_error_estimates": True}),
    "splu_complex": (_random_complex, "splu", {}),
    "gridmf": (lambda: _lap(8), "gridmf", {"grid": (8, 8, 1)}),
    "genmf": (lambda: _irregular(120), "auto",
              {"dense_threshold": 50, "max_block": 4}),
}


def _lap(npoint):
    ii, jj, vv = samples.laplacian_2d(npoint).triplets()
    return ii, jj, vv, npoint * npoint, Sym.NO


def _irregular(n):
    ii, jj, vv = samples.irregular_geometric(n, seed=3).triplets()
    return ii, jj, vv, n, Sym.NO


def _complexify(m):
    ii, jj, vv, n, sym = m
    return ii, jj, vv + 1j * 0.3 * np.arange(1, len(vv) + 1) / len(vv), n, sym


def _run_both(case, monkeypatch):
    make, genie, kw = CASES[case]
    ii, jj, vv, n, sym = make()
    jcoo, tcoo = _matrices(ii, jj, vv, n, sym)
    if case == "genmf":
        # several size classes at this n (the default leaf is 256)
        monkeypatch.setenv("RUSSELL_TPU_GENMF_LEAF", "16")
        monkeypatch.setattr(factor, "GENMF_LEAF", 16)
    rng = np.random.default_rng(42)
    cplx = np.iscomplexobj(vv)
    rhs = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0.0)
    js = JLinSolver(JGenie(genie))
    js.factorize(jcoo, JParams(compute_determinant=True, **kw))
    jx = np.asarray(js.solve(rhs))
    ts = LinSolver(Genie(genie), device="cpu")
    ts.factorize(tcoo, LinSolParams(compute_determinant=True, **kw))
    tx = ts.solve(rhs).numpy()
    return js, jx, ts, tx, tcoo, rhs


@pytest.mark.parametrize("case", list(CASES))
def test_lin_solver_matches_reference(case, monkeypatch):
    js, jx, ts, tx, tcoo, rhs = _run_both(case, monkeypatch)
    assert ts.plan.genie.value == js.plan.genie.value
    if case == "genmf":
        assert ts.plan.genie == Genie.GENMF
    if case.startswith("banded"):
        assert ts.plan.genie == Genie.BANDED
    np.testing.assert_allclose(tx, jx, rtol=RTOL,
                               atol=RTOL * np.abs(jx).max())
    assert VerifyLinSys.from_system(tcoo, tx, rhs).relative_error < 1e-12
    # the determinant: mantissa (with its complex phase) and exponent
    jm, jb, je = js.determinant()
    tm, tb, te = ts.determinant()
    assert (tb, te) == (jb, je)
    np.testing.assert_allclose(tm, jm, rtol=1e-11)
    assert type(tm) is type(jm)
    # the stats that do not name the platform
    jst, tst = json.loads(js.stats.get_json()), json.loads(ts.stats.get_json())
    assert set(tst) == set(jst)
    for sec in ("main", "matrix", "requests", "output", "determinant",
                "mumps_stats", "time_nanoseconds"):
        assert set(tst[sec]) == set(jst[sec]) - {"stepped_dispatch"}, sec
    assert tst["main"]["platform"] == "russell_tpu_torch"
    assert tst["main"]["solver"] == jst["main"]["solver"]
    assert tst["matrix"] == jst["matrix"]
    assert tst["requests"] == jst["requests"]
    for k in OUTPUT_KEYS:
        assert tst["output"][k] == jst["output"][k], k
    np.testing.assert_allclose(tst["output"]["min_pivot"],
                               jst["output"]["min_pivot"], rtol=RTOL)
    assert (tst["output"]["n_perturbed_pivots"]
            == jst["output"]["n_perturbed_pivots"])
    if case == "splu":
        for k in ("inf_norm_a", "inf_norm_x"):
            np.testing.assert_allclose(tst["mumps_stats"][k],
                                       jst["mumps_stats"][k], rtol=RTOL)
        for k in ("backward_error_omega1", "backward_error_omega2",
                  "normalized_delta_x", "scaled_residual"):
            assert 0.0 <= tst["mumps_stats"][k] < 1e-12, k


def test_error_analysis_and_condition_numbers_match_reference():
    ii, jj, vv, n, sym = _sample("umfpack_unsymmetric_5x5")
    jcoo, tcoo = _matrices(ii, jj, vv, n, sym)
    rhs = tcoo.as_dense() @ np.arange(1.0, 6.0)
    kw = dict(compute_error_estimates=True, compute_condition_numbers=True)
    js = JLinSolver(JGenie.DENSE)
    js.factorize(jcoo, JParams(**kw))
    js.solve(rhs)
    ts = LinSolver(Genie.DENSE, device="cpu")
    ts.factorize(tcoo, LinSolParams(**kw))
    x = ts.solve(rhs).numpy()
    np.testing.assert_allclose(x, np.arange(1.0, 6.0), rtol=1e-12)
    jm, tm = js.stats.mumps_stats, ts.stats.mumps_stats
    assert tm["inf_norm_a"] == jm["inf_norm_a"]
    for k in ("inf_norm_x", "condition_number1", "condition_number2"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(ts.stats.output["umfpack_rcond_estimate"],
                               js.stats.output["umfpack_rcond_estimate"],
                               rtol=1e-12)
    for k in ("backward_error_omega1", "backward_error_omega2",
              "normalized_delta_x"):
        assert 0.0 <= tm[k] < 1e-13, k
    a = tcoo.as_dense()
    assert tm["condition_number1"] <= np.linalg.cond(a, np.inf) * (1 + 1e-10)
    assert tm["condition_number2"] <= np.linalg.cond(a, 1) * (1 + 1e-10)


def test_helpers_match_reference():
    ii, jj, vv, n, sym = _sample("mkl_symmetric_5x5_lower")
    got = lin_solver._expand_full_pattern(ii, jj, vv, sym)
    want = jlin_solver._expand_full_pattern(ii, jj, vv, JSym[sym.name])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 6))
    for m in (a, a + a.T):
        i, j = np.nonzero(np.ones_like(m))
        assert (lin_solver._numeric_symmetry(6, i, j, m[i, j])
                == jlin_solver._numeric_symmetry(6, i, j, m[i, j]))


def test_refactorize_values_only_and_structure_change():
    ii, jj, vv, n, sym = _banded(n=120)
    tcoo = CooMatrix.from_arrays(n, n, ii, jj, vv, sym)
    s = LinSolver(Genie.BANDED, device="cpu")
    s.factorize(tcoo)
    tcoo.values[:tcoo.nnz] *= 3.0
    s.factorize(tcoo)
    x = s.solve(tcoo.as_dense() @ np.ones(n)).numpy()
    np.testing.assert_allclose(x, np.ones(n), rtol=1e-12)
    other = CooMatrix.from_dense(np.eye(n))
    with pytest.raises(ValueError, match="same structure"):
        s.factorize(other)


def test_errors():
    with pytest.raises(RuntimeError, match="factorize"):
        LinSolver(device="cpu").solve(np.ones(3))
    coo = samples.rectangular_3x4("cpu")[0]
    with pytest.raises(ValueError, match="square"):
        LinSolver(device="cpu").factorize(coo)
    sing = CooMatrix.from_dense(np.array([[1.0, 2.0], [2.0, 4.0]]),
                                zero_tol=-1.0)
    with pytest.raises(RuntimeError, match="singular"):
        LinSolver(device="cpu").factorize(sing)


@pytest.mark.parametrize("genie", ["dense", "splu"])
def test_mixed_precision_factorizes_in_f32(genie):
    # mixed precision runs (tests/test_torch_mixed.py holds it to the
    # reference on every genie): f32 factors, the refined x of the f64
    # solve, the reference's statistics keys
    coo = samples.umfpack_unsymmetric_5x5("cpu")[0]
    b = np.arange(1.0, 6.0)
    xs = {}
    for mixed in (False, True):
        s = LinSolver(Genie(genie), device="cpu")
        s.factorize(coo, LinSolParams(mixed_precision=mixed))
        assert s.plan.mixed32 is mixed
        xs[mixed] = s.solve(b).numpy()
    blk = s.fac["lu" if genie == "dense" else "blocks"]
    assert blk.dtype == torch.float32
    np.testing.assert_allclose(xs[True], xs[False], rtol=1e-12)
    assert "precision_escalated" not in s.stats.output


def test_solve_planes_and_kernel_fns():
    ii, jj, vv, n, sym = _random_complex()
    coo = CooMatrix.from_arrays(n, n, ii, jj, vv, sym)
    s = LinSolver(Genie.SPLU, device="cpu")
    s.factorize(coo)
    rng = np.random.default_rng(3)
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    xr, xi = s.solve_planes(b.real, b.imag)
    x = s.solve(b).numpy()
    np.testing.assert_array_equal(xr.numpy() + 1j * xi.numpy(), x)
    fact, solve = s.kernel_fns()
    x2 = solve(fact(torch.as_tensor(vv)), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(x2, x)
    assert s._backward_error(x, b) < 1e-14


def test_newton_nonlinear_system_through_lin_solver():
    """4-eq Newton iteration re-factorizing the frozen-structure Jacobian
    every step (russell_sparse/tests/test_nonlinear_system.rs): the same
    per-iteration iterate table, 5 iterations."""
    def residual(u):
        d1, d2, d3, d4 = u
        return np.array([
            2*d1 + d1**4 + d2 + 3*d1*d2*d2 - 9*d4 + d4**4 - 0.2,
            d1 + 3*d1*d1*d2 + 10*d2 + 4*d2*d2 + 2*d2*d3 - 8*d3 + 7*d4 + 0.1,
            -8*d2 + d2*d2 + 3*d3 + d3*d3 + 2*d4,
            -9*d1 + 4*d1*d4**3 + 7*d2 + 2*d3 + 5*d4 - 0.5])

    def jacobian(jj, u):
        d1, d2, d3, d4 = u
        jj.reset()
        for (i, j), v in np.ndenumerate(np.array([
                [2 + 4*d1**3 + 3*d2*d2, 1 + 6*d1*d2, 0.0, -9 + 4*d4**3],
                [1 + 6*d1*d2, 10 + 3*d1*d1 + 8*d2 + 2*d3, -8 + 2*d2, 7.0],
                [0.0, -8 + 2*d2, 3 + 2*d3, 2.0],
                [-9 + 4*d4**3, 7.0, 2.0, 5 + 12*d1*d4*d4]])):
            jj.put(i, j, v)

    uu_ref = np.array([
        [0.000000, 0.000000, 0.000000, 0.000000],
        [-0.236393, -0.106230, -0.225574, -0.086557],
        [-0.196773, -0.079071, -0.171604, -0.074904],
        [-0.194395, -0.077412, -0.168376, -0.074249],
        [-0.194386, -0.077406, -0.168364, -0.074246],
        [-0.194386, -0.077406, -0.168364, -0.074246]])
    jj = CooMatrix(4, 4, 16)
    solver = LinSolver(device="cpu")
    u = np.zeros(4)
    norm0 = None
    it = 0
    while it < 10:
        rr = residual(u)
        err = 1.0 if it == 0 else np.linalg.norm(rr) / norm0
        if it == 0:
            norm0 = np.linalg.norm(rr)
        np.testing.assert_allclose(u, uu_ref[it], atol=1e-6)
        if err < 1e-13:
            break
        jacobian(jj, u)
        solver.factorize(jj)
        u = u - solver.solve(rr).numpy()
        it += 1
    assert it == 5


def test_cli_matches_reference_json(tmp_path, capsys):
    coo = samples.irregular_geometric(300, seed=2)
    path = str(tmp_path / "geometric_300.mtx")
    write_matrix_market(coo, path)
    args = [path, "--genie", "banded", "--determinant", "--error-analysis"]
    assert jcli.main(args) == 0
    out = capsys.readouterr().out
    want = json.loads(out[out.index("{"):])
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = json.loads(out[out.index("{"):])
    assert got["main"]["platform"] == "russell_tpu_torch"
    assert got["main"]["solver"] == want["main"]["solver"] == "banded"
    assert got["matrix"] == want["matrix"]
    assert got["requests"] == want["requests"]
    for k in OUTPUT_KEYS:
        assert got["output"][k] == want["output"][k]
    for k in ("mantissa_real", "mantissa_imag"):
        np.testing.assert_allclose(got["determinant"][k],
                                   want["determinant"][k], rtol=1e-11)
    assert got["determinant"]["exponent"] == want["determinant"]["exponent"]
    for k in ("max_abs_a", "max_abs_ax"):
        np.testing.assert_allclose(got["verify"][k], want["verify"][k],
                                   rtol=RTOL)
    assert got["verify"]["relative_error"] < 1e-12
    assert set(got["time_human"]) == set(want["time_human"])
