"""The explicit Runge-Kutta and Euler methods of russell_tpu_torch, on the
CPU.

Each of the 13 ERK methods runs through both packages on Kreyszig's Ex. 4
p.920 and on the npoint-5 Brusselator PDE with the same inputs: counters
equal, y at rtol 1e-12. The dopri5.f, dop853.f and Euler oracles of
tests/test_ode.py are held on the port alone, with their constants copied
here.
"""

import numpy as np
import pytest
import torch

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, samples as jsamples
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

torch.set_num_threads(2)

COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")


def _counters(st):
    return {k: getattr(st, k) for k in COUNTERS}


@pytest.mark.parametrize("problem", ["kreyszig_ex4", "brusselator_5"])
@pytest.mark.parametrize("method", [m.name for m in Method.erk_methods()])
def test_erk_matches_reference(method, problem):
    if problem == "kreyszig_ex4":
        jsystem, x0, y0, _, _ = jsamples.kreyszig_ex4_page920()
        system, *_ = samples.kreyszig_ex4_page920()
        x1 = 1.0
    else:
        jsystem, x0, y0, _ = jsamples.brusselator_pde(2e-3, 5)
        system, *_ = samples.brusselator_pde(2e-3, 5)
        x1 = 0.3  # HEUN3's ten equal steps diverge on [0, 1]
    jsol = JOdeSolver(JParams(JMethod[method]), jsystem)
    yj = np.asarray(jsol.solve(y0, x0, x1))
    sol = OdeSolver(Params(Method[method]), system, "cpu")
    y = sol.solve(y0, x0, x1)
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12, atol=0)


def test_erk_methods_count():
    assert len(Method.erk_methods()) == 13


def test_dopri5_hairer_wanner_eq1_matches_fortran():
    # dopri5.f counters (tests/test_ode.py:16)
    system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()
    params = Params(Method.DOPRI5)
    params.step.h_ini = 1e-4
    sol = OdeSolver(params, system, "cpu")
    out = Output().set_dense_h_out(0.1).set_dense_recording([0])
    y = sol.solve(y0, x0, 1.5, args=args, output=out)
    st = sol.stats()
    assert abs(float(y[0]) - 9.063921649310544E-02) < 1e-13
    assert abs(float(y[0]) - float(y_fn(1.5, None)[0])) < 4e-5
    assert (st.n_function, st.n_steps, st.n_accepted,
            st.n_rejected) == (235, 39, 39, 0)
    assert len(out.dense_x()) == 16


def test_dopri5_arenstorf_matches_fortran():
    # dopri5.f on the Arenstorf orbit (tests/test_ode.py:321)
    system, x0, y0, x1, args, y_ref = samples.arenstorf()
    params = Params(Method.DOPRI5)
    params.step.h_ini = 1e-4
    params.set_tolerances(1e-7, 1e-7)
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, x1, args=args).numpy()
    st = sol.stats()
    assert abs(y[0] - 9.940021704030663E-01) < 1e-11
    assert abs(y[1] - 9.040891036151961E-06) < 1e-11
    assert abs(y[2] - 1.459758305600828E-03) < 1e-9
    assert abs(y[3] - (-2.001245515834718E+00)) < 1e-9
    assert abs(st.h_accepted - 5.258587607119909E-04) < 1e-10
    assert (st.n_function, st.n_steps, st.n_accepted,
            st.n_rejected) == (1429, 238, 217, 21)


def test_dopri8_van_der_pol_matches_fortran():
    # dop853.f with dense output h 0.1 (tests/test_ode.py:342; the
    # reference's n_function differs from pure dop853's by 2)
    system, _, _, _, args = samples.van_der_pol(1e-3, False)
    params = Params(Method.DOPRI8)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-9, 1e-9)
    sol = OdeSolver(params, system, "cpu")
    out = Output().set_dense_h_out(0.1).set_dense_recording([0, 1])
    y = sol.solve(np.array([2.0, 0.0]), 0.0, 2.0, args=args, output=out)
    st = sol.stats()
    assert abs(float(y[0]) - 1.763234540172087E+00) < 1e-13
    assert abs(float(y[1]) - (-8.356886819301910E-01)) < 1e-12
    assert (st.n_steps, st.n_accepted, st.n_rejected,
            st.n_function) == (1469, 1348, 121, 21553 - 2)


def test_mdeuler_hairer_wanner_counters():
    # the modified-Euler embedded pair (tests/test_ode.py:529)
    system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()
    params = Params(Method.MD_EULER)
    params.step.h_ini = 1e-4
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, 1.5, args=args).numpy()
    st = sol.stats()
    assert abs(y[0] - 0.09062475637905158) < 1e-16
    assert abs(y[0] - float(y_fn(1.5, None)[0])) < 1e-4
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted,
            st.n_rejected) == (424, 0, 0, 0, 212, 212, 0)


def test_bweuler_hairer_wanner_counters():
    # fixed-step backward Euler (tests/test_ode.py:516), through DENSE
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    sol = OdeSolver(Params(Method.BW_EULER), system, "cpu")
    y = sol.solve(y0, x0, 1.5, args=args, h_equal=1.875 / 50.0).numpy()
    st = sol.stats()
    assert abs(y[0] - 0.09060476604187756) < 1e-15
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected,
            st.n_iterations_max) == (80, 40, 40, 40, 40, 40, 0, 2)


def test_equal_stepping_counts():
    # RK4, h 0.2 (tests/test_ode.py:190; Kreyszig Table 21.4 p.904)
    system, x0, y0, args, y_fn = samples.kreyszig_eq6_page902()
    sol = OdeSolver(Params(Method.RK4), system, "cpu")
    y = sol.solve(y0, x0, 1.0, h_equal=0.2, args=args)
    st = sol.stats()
    assert (st.n_steps, st.n_accepted) == (5, 5)
    assert abs(float(y[0]) - 0.718251) < 1e-6


@pytest.mark.parametrize("method", [m.name for m in Method.erk_methods()])
def test_erk_methods_on_kreyszig(method):
    # tests/test_ode.py:71: y' = x + y with h 0.01
    system, x0, y0, args, y_fn = samples.kreyszig_eq6_page902()
    m = Method[method]
    sol = OdeSolver(Params(m), system, "cpu")
    y = sol.solve(y0, x0, 1.0, h_equal=0.01, args=args)
    tol = 3e-4 if m.information().order <= 2 else 1e-6
    assert abs(float(y[0]) - float(y_fn(1.0, None)[0])) < tol


def test_fweuler_and_bweuler_on_kreyszig():
    # tests/test_ode.py:81, and both against the reference at h 0.01
    system, x0, y0, args, y_fn = samples.kreyszig_eq6_page902()
    jsystem, *_ = jsamples.kreyszig_eq6_page902()
    for method in (Method.FW_EULER, Method.BW_EULER):
        sol = OdeSolver(Params(method), system, "cpu")
        y = sol.solve(y0, x0, 1.0, h_equal=0.001, args=args)
        assert abs(float(y[0]) - float(y_fn(1.0, None)[0])) < 2e-3
        y = sol.solve(y0, x0, 1.0, h_equal=0.01, args=args)
        jsol = JOdeSolver(JParams(JMethod[method.name]), jsystem)
        yj = np.asarray(jsol.solve(y0, x0, 1.0, h_equal=0.01))
        assert _counters(sol.stats()) == _counters(jsol.stats())
        np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12)


def test_fsal_stage_is_not_overwritten():
    # DoPri5's first stage of a step is the previous step's last (a copy
    # in the reference package): here the stage list keeps that tensor,
    # so no later step may write a stage tensor in place
    system, x0, y0, args, _ = samples.kreyszig_eq6_page902()
    sol = OdeSolver(Params(Method.DOPRI5), system, "cpu")
    y = sol.solve(y0, x0, 0.5)
    k0 = sol.actual.k[0]
    assert k0 is sol.actual.k[sol.actual.nstage - 1]
    saved = k0.clone()
    sol.solve(y, 0.5, 1.0)
    torch.testing.assert_close(k0, saved, rtol=0, atol=0)
