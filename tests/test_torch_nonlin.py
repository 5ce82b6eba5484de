"""Continuation of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_nonlin.py`` is the checklist: each of its runs goes through
the reference's ``Solver`` and the port's under one configuration (the
reference's ``Config`` carried across by ``interop``), and the eight
counters must be equal, the recorded steps' λ and u within 1e-9 (the
packages' sums and products round apart in the last bits: XLA's jitted
CPU code against torch's eager ops). Beside them: the 2-D Bratu fold at
npoint 17 polished in torch, and the autodiff ``System``
(``torch.func.jacfwd``) against the analytic Jacobians and the
reference's ``jax.jacfwd``. f64 on the CPU.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import russell_tpu.nonlin as J
import russell_tpu_torch.nonlin as P
from russell_tpu_torch.interop import (nonlin_config_from_reference,
                                       output_to_numpy)

# the recorded steps' λ and u (last-bit differences of the two packages'
# arithmetic, carried through a continuation)
STEP_TOL = 1e-9
COUNTERS = ("n_steps", "n_accepted", "n_rejected", "n_function",
            "n_jacobian", "n_factor", "n_lin_sol", "n_iteration_total")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


def _run(sample, args, config_kw, u0, l0, direction, stop, ddl, record):
    """One continuation through both packages: (reference, port), each a
    dict of u, l, status, counters and the output records."""
    res = []
    jconfig = J.Config(**config_kw)
    for pkg in (J, P):
        system = getattr(pkg.samples, sample)(*args)[0]
        if pkg is J:
            solver = J.Solver(jconfig, system)
        else:
            solver = P.Solver(nonlin_config_from_reference(jconfig), system,
                              device="cpu")
        out = pkg.Output().set_recording(record)
        u, l, status = solver.solve(
            np.asarray(u0), l0, getattr(pkg.IniDir, direction),
            stop(pkg.Stop), ddl(pkg.DeltaLambda), output=out)
        res.append({"u": np.asarray(u), "l": l, "status": status.name,
                    "counters": _counters(solver.stats()),
                    "out": output_to_numpy(out)})
    return res


def _assert_same_run(ref, got):
    assert got["status"] == ref["status"]
    assert got["counters"] == ref["counters"]
    np.testing.assert_allclose(got["u"], ref["u"], rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert got["l"] == pytest.approx(ref["l"], rel=STEP_TOL, abs=STEP_TOL)
    ro, go = ref["out"], got["out"]
    np.testing.assert_allclose(go["step_l"], ro["step_l"], rtol=STEP_TOL,
                               atol=STEP_TOL)
    np.testing.assert_allclose(go["step_h"], ro["step_h"], rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert go["step_u"].keys() == ro["step_u"].keys()
    for m in ro["step_u"]:
        np.testing.assert_allclose(go["step_u"][m], ro["step_u"][m],
                                   rtol=STEP_TOL, atol=STEP_TOL)


NEWTON = dict(method=J.Method.NATURAL, euler_predictor=False)
ARC = dict(method=J.Method.ARCLENGTH)

# (id, sample, args, config, u0 or None (the sample's), l0, direction,
#  stop, delta lambda): the runs of tests/test_nonlin.py
CASES = [
    ("newton_two_eq_ref", "two_eq_ref", (), NEWTON, None, 0.0, "POS",
     lambda S: S.steps(1), lambda D: D.constant(1.0)),
    ("natural_fold", "one_eq_with_fold_point", (), dict(
        method=J.Method.NATURAL), None, 0.0, "POS",
     lambda S: S.max_lambda(0.3), lambda D: D.constant(0.02)),
    ("arclength_circle", "circle_ul", (1.0,), ARC, None,
     1.0 / math.sqrt(2.0), "NEG", lambda S: S.steps(200),
     lambda D: D.constant(0.05)),
    ("arclength_past_fold", "one_eq_with_fold_point", (), ARC, None, 0.0,
     "POS", lambda S: S.max_comp_u(0, 2.5), lambda D: D.constant(0.05)),
    ("delta_lambda_list", "one_eq_with_fold_point", (), dict(
        method=J.Method.NATURAL), None, 0.0, "POS",
     lambda S: S.steps(3), lambda D: D.from_list([0.1, 0.05, 0.02])),
    ("cubic_ok", "cubic_poly_1", (), NEWTON, [1.0], 0.0, "POS",
     lambda S: S.steps(1), lambda D: D.constant(1.0)),
    ("cubic_oscillation", "cubic_poly_1", (), NEWTON, [0.0], 0.0, "POS",
     lambda S: S.steps(1), lambda D: D.constant(1.0)),
    ("cubic_2", "cubic_poly_2", (), dict(NEWTON, n_iteration_max=60), None,
     0.0, "POS", lambda S: S.steps(1), lambda D: D.constant(1.0)),
    ("singular_initial_state", "singular_initial_state", (1.0 / 3.0, 0.05),
     ARC, None, 0.0, "POS", lambda S: S.steps(5),
     lambda D: D.constant(0.5)),
    ("simple_linear", "simple_linear_problem", (), NEWTON, None, 0.0, "POS",
     lambda S: S.steps(1), lambda D: D.constant(1.0)),
    ("bspline_arclength", "bspline_problem_1", (1.5,), dict(
        ARC, bordering=False, tg_control_tol=0.2), None, 0.0, "POS",
     lambda S: S.max_lambda(1.0), lambda D: D.auto(0.01)),
    ("bspline_natural", "bspline_problem_1", (1.5,), dict(
        method=J.Method.NATURAL), None, 0.0, "POS",
     lambda S: S.max_lambda(1.0), lambda D: D.auto(0.01)),
    ("bratu_1d_arclength", "bratu_1d_spc", (20, 0.2), ARC, None, 0.0, "POS",
     lambda S: S.max_comp_u(9, 20.0), lambda D: D.auto(0.5)),
    ("bratu_1d_natural", "bratu_1d_spc", (20,), dict(
        method=J.Method.NATURAL), None, 0.0, "POS",
     lambda S: S.max_lambda(3.4), lambda D: D.auto(0.5)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_counters_and_steps_match_reference(case):
    _, sample, args, config_kw, u0, l0, direction, stop, ddl = case
    system, *rest = getattr(P.samples, sample)(*args)
    if u0 is None:
        u0 = rest[0]
    ref, got = _run(sample, args, config_kw, u0, l0, direction, stop, ddl,
                    list(range(system.ndim)))
    _assert_same_run(ref, got)
    if case[0].startswith("bratu_1d_arclength"):
        # the path passed both folds of alpha = 0.2 (tests/test_nonlin.py)
        ls = got["out"]["step_l"]
        assert np.sum(np.diff(np.sign(np.diff(ls))) != 0) == 2


def test_singular_jacobian_raises_as_reference():
    # two_eq_nr_prob_1 starts where Gu is singular: both packages refuse
    # the factorization (the single min|pivot| == 0 check)
    for pkg in (J, P):
        system, u0, _ = pkg.samples.two_eq_nr_prob_1()
        kw = {} if pkg is J else {"device": "cpu"}
        solver = pkg.Solver(pkg.Config(method=pkg.Method.NATURAL,
                                       euler_predictor=False), system, **kw)
        with pytest.raises(RuntimeError, match="Gu is singular"):
            solver.solve(u0, 0.0, pkg.IniDir.POS, pkg.Stop.steps(1),
                         pkg.DeltaLambda.constant(1.0))


def test_bratu_2d_fold_at_npoint_17():
    # tests/test_nonlin.py::test_arclength_bratu_2d_fdm_fold: counters equal
    # to the reference's, then the discrete fold polished in torch
    system, u0, l0, mid = P.samples.bratu_2d_fdm(17, 0.0)
    n = system.ndim
    ref, got = _run("bratu_2d_fdm", (17, 0.0), ARC, u0, l0, "POS",
                    lambda S: S.max_comp_u(mid, 6.0),
                    lambda D: D.auto(0.5), list(range(n)))
    _assert_same_run(ref, got)
    ls = got["out"]["step_l"]
    j = int(np.argmax(ls))
    uj = torch.as_tensor(np.array([got["out"]["step_u"][m][j]
                                   for m in range(n)]))
    lam = chip_smoke.fold_polish(system, uj, float(ls[j]),
                                 chip_smoke.dense_gu(system))
    assert abs(lam - 6.80812442259) < 0.015
    assert abs(lam - 6.80217410) < 1e-5  # the npoint-17 discrete fold


@pytest.mark.parametrize("npoint,genie", [(17, "DENSE"), (33, "BANDED")])
def test_bratu_2d_fold_sparse_polish(npoint, genie):
    # chip_smoke's fold polish through factor (the one it runs at npoint
    # 257), from the port's largest recorded step, against russell_tpu's
    # fold (and at npoint 17 against the dense polish)
    from russell_tpu_torch.sparse import Genie, factor
    system, u0, l0, mid = P.samples.bratu_2d_fdm(npoint)
    solver = P.Solver(P.Config(method=P.Method.ARCLENGTH), system,
                      device="cpu")
    top = {}

    def keep_top(stats, h, l, u, args):
        if not top or l > top["l"]:
            top.update(l=l, u=u.copy())
        return False

    out = P.Output().set_step_callback(keep_top)
    _, _, status = solver.solve(u0, l0, P.IniDir.POS,
                                P.Stop.max_comp_u(mid, 6.0),
                                P.DeltaLambda.auto(0.5), output=out)
    assert status.success()
    plan = factor.analyze(system.ndim, system.jac_ii, system.jac_jj,
                          genie=getattr(Genie, genie))
    factor.prepare(plan, "cpu")
    u = torch.as_tensor(top["u"])
    lam, info = chip_smoke.fold_polish_sparse(system, plan, u, top["l"])
    if npoint == 17:    # the dense polish takes minutes at npoint 33
        dense = chip_smoke.fold_polish(system, u, top["l"],
                                       chip_smoke.dense_gu(system))
        assert abs(lam - dense) < 1e-10
    assert abs(lam - chip_smoke.BRATU_REF_FOLDS[npoint]) < 1e-10
    # the fold solves the extended system: G = 0 and Gu v = 0
    assert info["g_max"] < 1e-9 and info["guv_max"] < 1e-9
    assert top["l"] < lam


def _gg_two_eq(pkg):
    lib = torch if pkg is P else __import__("jax.numpy", fromlist=["stack"])
    return lambda l, u, args: lib.stack([u[0] ** 3 + u[1] - l,
                                         -u[0] + u[1] ** 3 + 1.0])


@pytest.mark.parametrize("sample,args", [
    ("two_eq_ref", ()), ("bratu_1d_spc", (8, 0.2)),
    ("bspline_problem_1", (1.5,)), ("one_eq_with_fold_point", ()),
    ("circle_ul", (1.0,)), ("bratu_2d_fdm", (6, 0.1))])
def test_autodiff_system_matches_analytic_jacobian(sample, args):
    # check_ggu: the analytic Gu against torch.func.jacfwd, at a seeded u
    system = getattr(P.samples, sample)(*args)[0]
    rng = np.random.default_rng(7)
    u = 0.5 + 0.3 * rng.random(system.ndim)
    system.check_ggu(0.3, u, None, 1e-10)
    # an autodiff System on the analytic one's residual: the dense Gu and
    # G_lambda equal the analytic values
    ad = P.System(system.ndim, system.calc_gg)
    ut = torch.as_tensor(u)
    vals, ggl = ad.calc_jac(0.3, ut, None)
    dense = np.zeros((system.ndim, system.ndim))
    av, agl = system.calc_jac(0.3, ut, None)
    np.add.at(dense, (system.jac_ii, system.jac_jj), av.numpy())
    np.testing.assert_allclose(vals.numpy().reshape(dense.shape), dense,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ggl.numpy(), agl.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_autodiff_system_matches_reference():
    # the same residual through both packages' autodiff Systems: Gu and
    # G_lambda at a seeded point
    rng = np.random.default_rng(3)
    u = rng.random(2)
    jv, jl = J.System(2, _gg_two_eq(J)).calc_jac(0.7, np.asarray(u), None)
    pv, pl = P.System(2, _gg_two_eq(P)).calc_jac(0.7, torch.as_tensor(u),
                                                 None)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-14)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-14)


def test_config_and_output_interop():
    jconfig = J.Config(method=J.Method.ARCLENGTH, tol_abs_residual=1e-11,
                       genie=J.Config.genie.__class__.SPLU,
                       tg_control_rdiff_type="max", bordering=False)
    config = nonlin_config_from_reference(jconfig)
    assert config.method == P.Method.ARCLENGTH
    assert config.genie.name == "SPLU"
    assert config.tol_abs_residual == 1e-11
    assert config.tg_control_rdiff_type == "max" and not config.bordering
    out = P.Output().set_recording([1])
    assert output_to_numpy(out)["step_u"] == {1: pytest.approx([])}


def test_solver_resolves_device():
    system = P.samples.two_eq_ref()[0]
    solver = P.Solver(P.Config(), system, device="cpu")
    assert solver.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            P.Solver(P.Config(), system)    # the card by default
