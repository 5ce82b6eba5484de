"""Radau5 + SPLU through russell_tpu_torch (the whole slice), on the CPU.

Van der Pol runs through the port alone, against radau5.f's counters
(tests/test_ode.py:57-68); the npoint-5 Brusselator runs through both
packages with the same inputs and must give equal counters and y.
"""

import numpy as np
import pytest
import torch

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Output as JOutput, Params as JParams
from russell_tpu.ode import samples as jsamples
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples
from russell_tpu_torch.sparse import CooMatrix
from russell_tpu_torch.sparse.enums import Genie

torch.set_num_threads(2)

COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")


def _counters(st):
    return {k: getattr(st, k) for k in COUNTERS}


def test_radau5_splu_van_der_pol_matches_fortran():
    # THE parity oracle: all 9 counters of radau5.f (test_ode.py:57-68)
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.newton.genie = Genie.SPLU
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, x1, args=args)
    st = sol.stats()
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    assert abs(float(y[0]) - 1.706163410178079E+00) < 1e-12
    assert abs(float(y[1]) - (-8.927971289301175E-01)) < 1e-11
    assert abs(st.h_accepted - 1.510987221365367E-01) < 1e-6
    assert _counters(st) == {
        "n_function": 2249, "n_jacobian": 162, "n_factor": 253,
        "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
        "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6}


def test_radau5_splu_brusselator_matches_reference():
    npoint = 5
    jsystem, t0, y0, _ = jsamples.brusselator_pde(2e-3, npoint)
    jparams = JParams(JMethod.RADAU5)
    jparams.newton.genie = JGenie.SPLU
    jsol = JOdeSolver(jparams, jsystem)
    yj = np.asarray(jsol.solve(y0, t0, 1.0))

    system, t0, y0t, _ = samples.brusselator_pde(2e-3, npoint)
    np.testing.assert_array_equal(y0t, y0)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.SPLU
    sol = OdeSolver(params, system, "cpu")
    yt = sol.solve(y0t, t0, 1.0).numpy()

    assert _counters(sol.stats()) == _counters(jsol.stats())
    # the oracle of the JAX package on this problem and genie
    st = sol.stats()
    assert (st.n_accepted, st.n_rejected, st.n_factor, st.n_lin_sol,
            st.n_jacobian) == (27, 3, 29, 71, 23)
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=0)


def test_radau5_identity_mass_matrix_matches_no_mass():
    # the DAE path (M y' = f through the mass triplets) with M = I must
    # reproduce the plain ODE run exactly
    runs = []
    for with_mass in (False, True):
        system, t0, y0, _ = samples.brusselator_pde(2e-3, 4)
        if with_mass:
            mass = CooMatrix(system.ndim, system.ndim, system.ndim)
            for i in range(system.ndim):
                mass.put(i, i, 1.0)
            system.set_mass(mass)
        params = Params(Method.RADAU5)
        params.newton.genie = Genie.SPLU
        sol = OdeSolver(params, system, "cpu")
        runs.append((sol.solve(y0, t0, 0.5), _counters(sol.stats())))
    assert sol.actual._has_mass
    assert runs[0][1] == runs[1][1]
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)


def test_brusselator_samples_match_reference():
    # f and the analytic Jacobian, operation for operation, on a random y
    for second_book in (False, True):
        jsystem, *_ = jsamples.brusselator_pde(2e-3, 6, second_book)
        system, *_ = samples.brusselator_pde(2e-3, 6, second_book)
        np.testing.assert_array_equal(system.jac_structure[0],
                                      jsystem.jac_structure[0])
        np.testing.assert_array_equal(system.jac_structure[1],
                                      jsystem.jac_structure[1])
        y = np.random.default_rng(1).uniform(0.5, 2.0, system.ndim)
        for t in (0.5, 1.2):
            np.testing.assert_allclose(
                system.function(t, torch.as_tensor(y), None).numpy(),
                np.asarray(jsystem.function(t, y, None)), rtol=1e-15,
                atol=1e-15)
        np.testing.assert_allclose(
            system.jacobian(0.0, torch.as_tensor(y), None).numpy(),
            np.asarray(jsystem.jacobian(0.0, y, None)), rtol=1e-15)
    assert system.grid is None and samples.brusselator_pde(
        2e-3, 6)[0].grid == (6, 6, 2)


@pytest.mark.parametrize("what", ["method", "fused", "output", "genie",
                                  "numerical_jacobian", "solve_batch"])
def test_unported_paths_raise(what):
    """The paths that earlier slices refused. ``method`` (DoPri5),
    ``output``, ``genie`` (AUTO, which routes van der Pol to DENSE) and
    ``numerical_jacobian`` are ported now and must give the reference
    package's counters, through AUTO's DENSE route. ``fused`` is ported
    too and must give radau5.f's counters through SPLU; ``solve_batch``
    through SPLU still raises, naming ROADMAP.md (a batch factorizes
    through DENSE only)."""
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    params = Params(Method.DOPRI5 if what == "method" else Method.RADAU5)
    params.newton.genie = (Genie.SPLU if what in ("fused", "solve_batch")
                           else Genie.AUTO)
    params.newton.use_numerical_jacobian = what == "numerical_jacobian"
    if what == "fused":
        params.step.h_ini = 1e-6
        sol = OdeSolver(params, system, "cpu")
        y = sol.solve(y0, x0, x1, fused=True)
        st = sol.stats()
        assert sol.actual.plan.genie == Genie.SPLU
        assert abs(float(y[0]) - 1.706163410178079E+00) < 1e-12
        assert abs(float(y[1]) - (-8.927971289301175E-01)) < 1e-11
        assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
                st.n_steps, st.n_accepted, st.n_rejected,
                st.n_iterations_max) == (2249, 162, 253, 668, 280, 242, 8, 6)
        return
    if what == "solve_batch":
        sol = OdeSolver(params, system, "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sol.solve_batch(np.stack([y0, y0]), x0, x1)
        return
    # short runs: the reference package runs them too (DoPri5 takes steps
    # of ~3e-6 on this stiff problem)
    x1 = 1e-4 if what == "method" else 0.05
    jsystem, *_ = jsamples.van_der_pol(1e-6, False)
    jparams = JParams(JMethod[params.method.name])
    jparams.newton.genie = JGenie[params.newton.genie.name]
    jparams.newton.use_numerical_jacobian = what == "numerical_jacobian"
    jsol = JOdeSolver(jparams, jsystem)
    sol = OdeSolver(params, system, "cpu")
    out = Output().set_step_recording([0, 1]) if what == "output" else None
    jout = JOutput().set_step_recording([0, 1]) if what == "output" else None
    y = sol.solve(y0, x0, x1, output=out).numpy()
    yj = np.asarray(jsol.solve(y0, x0, x1, output=jout))
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(y, yj, rtol=1e-10)
    if what == "genie":
        assert sol.actual.plan.genie == Genie.DENSE
    if what == "output":
        np.testing.assert_allclose(out.step_x, jout.step_x, rtol=1e-10)
        np.testing.assert_allclose(out.step_y(1), jout.step_y(1),
                                   rtol=1e-10)


def test_device_helper():
    import russell_tpu_torch
    assert russell_tpu_torch.device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert russell_tpu_torch.device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            russell_tpu_torch.device("cuda")
