"""The ODE samples of russell_tpu_torch against russell_tpu's, and the
radau5.f and Euler oracles through the DENSE route, on the CPU.

Each sample's rhs and Jacobian go through both packages on the same
seeded y; the radau5.f counters of tests/test_ode.py are held on the port
alone (constants copied here), through ``Genie.AUTO``, which routes these
small systems to DENSE as the reference does; Radau5 and BwEuler on the
npoint-5 Brusselator (AUTO -> DENSE) match the reference's counters and y.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, System as JSystem
from russell_tpu.ode import samples as jsamples
from russell_tpu_torch.ode import (Method, OdeSolver, Output, Params, System,
                                   samples)
from russell_tpu_torch.sparse import read_matrix_market
from russell_tpu_torch.sparse.enums import Genie

torch.set_num_threads(2)

COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")
SAMPLES = ["simple_equation_constant", "simple_system_with_mass_matrix",
           "brusselator_ode", "arenstorf", "hairer_wanner_eq1", "robertson",
           "van_der_pol", "amplifier1t", "kreyszig_eq6_page902",
           "kreyszig_ex4_page920"]


def _counters(st):
    return {k: getattr(st, k) for k in COUNTERS}


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_matches_reference(name):
    got = getattr(samples, name)()
    want = getattr(jsamples, name)()
    assert len(got) == len(want)
    system, jsystem = got[0], want[0]
    assert system.ndim == jsystem.ndim
    for g, w in zip(got[1:], want[1:]):
        if callable(w):  # y_fn_x: host functions of (x, args)
            for x in (0.0, 0.37, 1.5):
                np.testing.assert_array_equal(g(x, None), w(x, None))
        elif w is None or np.isscalar(w):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    assert (system.jacobian is None) == (jsystem.jacobian is None)
    if jsystem.jacobian is not None:
        np.testing.assert_array_equal(system.jac_structure[0],
                                      jsystem.jac_structure[0])
        np.testing.assert_array_equal(system.jac_structure[1],
                                      jsystem.jac_structure[1])
    rng = np.random.default_rng(7)
    for x in (0.0, 0.013, 1.2):
        y = rng.uniform(0.5, 1.5, system.ndim)
        yt = torch.as_tensor(y)
        np.testing.assert_allclose(system.function(x, yt, None).numpy(),
                                   np.asarray(jsystem.function(x, y, None)),
                                   rtol=1e-14, atol=1e-300)
        if jsystem.jacobian is not None:
            np.testing.assert_allclose(
                system.jacobian(x, yt, None).numpy(),
                np.asarray(jsystem.jacobian(x, y, None)), rtol=1e-14,
                atol=1e-300)
    if jsystem.mass is not None:
        for a, b in zip(system.mass.triplets(), jsystem.mass.triplets()):
            np.testing.assert_array_equal(a, b)
        assert system.mass.sym.value == jsystem.mass.sym.value


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_rhs_takes_autodiff_and_numerical_jacobians(name):
    # every rhs is functional: torch.func.jacfwd and vmap trace it. The
    # autodiff Jacobian equals the sample's analytic one (arenstorf has
    # none: the reference's autodiff), the forward differences agree to
    # their truncation error
    system = getattr(samples, name)()[0]
    n = system.ndim
    y = np.random.default_rng(5).uniform(0.5, 1.5, n)
    if system.jacobian is not None:
        want = np.zeros((n, n))
        ii, jj = system.jac_structure
        np.add.at(want, (ii, jj),
                  system.jacobian(0.3, torch.as_tensor(y), None).numpy())
    else:
        jsystem = getattr(jsamples, name)()[0]
        _, jjac = JSystem(n, jsystem.function).jac_values_fn(False)
        want = np.asarray(jjac(0.3, jnp.asarray(y), None)).reshape(n, n)
    for numerical, tol in ((False, 1e-12), (True, 1e-5)):
        _, jac = System(n, system.function).jac_values_fn(numerical)
        got = jac(0.3, torch.as_tensor(y), None).numpy().reshape(n, n)
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.max(np.abs(want)))


def test_mass_matrix_lower_triangle_matches_reference():
    system, *_ = samples.simple_system_with_mass_matrix(True)
    jsystem, *_ = jsamples.simple_system_with_mass_matrix(True)
    for a, b in zip(system.mass.triplets(), jsystem.mass.triplets()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", [m.name for m in Method])
def test_every_method_constructs_and_solves(method):
    system, x0, y0, args, y_fn = samples.kreyszig_eq6_page902()
    sol = OdeSolver(Params(Method[method]), system, "cpu")
    y = sol.solve(y0, x0, 0.1, args=args)
    assert abs(float(y[0]) - float(y_fn(0.1, None)[0])) < 1e-3
    # the fused loop and solve_batch take Radau5 and the embedded ERK
    # methods; the others raise ValueError, as the reference package does
    info = Method[method].information()
    if Method[method] == Method.RADAU5 or (info.embedded
                                           and not info.implicit):
        yf = sol.solve(y0, x0, 0.1, fused=True)
        assert abs(float(yf[0]) - float(y_fn(0.1, None)[0])) < 1e-3
        yb, st = sol.solve_batch(np.stack([y0, y0]), x0, 0.1)
        assert st["status"].tolist() == [1, 1]
        np.testing.assert_array_equal(yb[0].numpy(), yf.numpy())
    else:
        with pytest.raises(ValueError):
            sol.solve(y0, x0, 0.1, fused=True)
        with pytest.raises(ValueError):
            sol.solve_batch(np.stack([y0, y0]), x0, 0.1)


def test_mass_matrix_needs_radau5():
    system, *_ = samples.amplifier1t()
    with pytest.raises(ValueError, match="Radau5"):
        OdeSolver(Params(Method.DOPRI5), system, "cpu")


def test_update_params():
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    sol = OdeSolver(Params(Method.DOPRI5), system, "cpu")
    p = Params(Method.DOPRI5)
    p.set_tolerances(1e-8, 1e-8)
    sol.update_params(p)
    assert sol.actual.params is p
    with pytest.raises(ValueError, match="method"):
        sol.update_params(Params(Method.RADAU5))


def test_radau5_van_der_pol_dense_matches_fortran():
    # radau5.f's nine counters (tests/test_ode.py:47) through AUTO -> DENSE,
    # with dense output h 0.2
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    sol = OdeSolver(params, system, "cpu")
    out = Output().set_dense_h_out(0.2).set_dense_recording([0, 1])
    y = sol.solve(y0, x0, x1, args=args, output=out)
    st = sol.stats()
    assert sol.actual.plan.genie == Genie.DENSE
    assert abs(float(y[0]) - 1.706163410178079E+00) < 1e-12
    assert abs(float(y[1]) - (-8.927971289301175E-01)) < 1e-11
    assert abs(st.h_accepted - 1.510987221365367E-01) < 1e-6
    assert _counters(st) == {
        "n_function": 2249, "n_jacobian": 162, "n_factor": 253,
        "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
        "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6}
    assert len(out.dense_x()) == 11


def test_radau5_hairer_wanner_eq1():
    # tests/test_ode.py:34
    system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-4
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, 1.5, args=args)
    st = sol.stats()
    assert abs(float(y[0]) - float(y_fn(1.5, None)[0])) < 5e-5
    assert st.n_accepted > 0 and st.n_jacobian >= 1


def test_radau5_robertson_matches_fortran():
    # tests/test_ode.py:362
    system, x0, y0, args = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-8, 1e-2)
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, 0.3, args=args).numpy()
    st = sol.stats()
    assert abs(y[0] - 9.886740138499884E-01) < 1e-15
    assert abs(y[1] - 3.447720471782070E-05) < 1e-15
    assert abs(y[2] - 1.129150894529390E-02) < 1e-15
    assert abs(st.h_accepted - 8.160578540333708E-01) < 1e-10
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted,
            st.n_rejected) == (88, 8, 15, 24, 17, 15, 1)


def test_radau5_robertson_small_h_failure_counters():
    # tests/test_ode.py:500: the failure path matches radau5.f too
    system, x0, y0, args = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-2, 1e-2)
    sol = OdeSolver(params, system, "cpu")
    with pytest.raises(RuntimeError, match="stepsize becomes too small"):
        sol.solve(y0, x0, 0.3, args=args)
    st = sol.stats()
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected,
            st.n_iterations_max) == (520, 57, 75, 153, 75, 60, 4, 4)


def test_radau5_amplifier1t_matches_fortran():
    # tests/test_ode.py:97: singular mass matrix
    system, x0, y0, args = samples.amplifier1t()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-4, 1e-4)
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, 0.05, args=args).numpy()
    st = sol.stats()
    assert abs(y[0] - (-2.226517868073645E-02)) < 1e-10
    assert abs(y[1] - 3.068700099735197E+00) < 1e-10
    assert abs(y[2] - 2.898340496450958E+00) < 1e-9
    assert abs(y[3] - 2.033525366489690E+00) < 1e-7
    assert abs(y[4] - (-2.269179823457655E+00)) < 1e-7
    assert abs(st.h_accepted - 7.791381954171996E-04) < 1e-6
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected,
            st.n_iterations_max) == (1511, 126, 166, 461, 166, 127, 6, 5)


def test_radau5_mass_matrix_dae():
    # tests/test_ode.py:89
    system, x0, y0, args, y_fn = samples.simple_system_with_mass_matrix()
    sol = OdeSolver(Params(Method.RADAU5), system, "cpu")
    y = sol.solve(y0, x0, 20.0, args=args)
    np.testing.assert_allclose(y.numpy(), y_fn(20.0, None), atol=1e-3)


def test_radau5_lower_triangle_mass_matches_reference():
    # Radau5 reads the mass matrix's stored triplets in both packages, so
    # a lower-triangle storage leaves out the upper entry (ROADMAP.md §3):
    # the port gives the reference's y, not y_fn's
    system, x0, y0, args, _ = samples.simple_system_with_mass_matrix(True)
    jsystem, *_ = jsamples.simple_system_with_mass_matrix(True)
    sol = OdeSolver(Params(Method.RADAU5), system, "cpu")
    jsol = JOdeSolver(JParams(JMethod.RADAU5), jsystem)
    y = sol.solve(y0, x0, 2.0).numpy()
    yj = np.asarray(jsol.solve(y0, x0, 2.0))
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(y, yj, rtol=1e-10)


def test_brusselator_ode_radau5_and_dopri8():
    # tests/test_ode.py:118, :127
    for method, atol in ((Method.RADAU5, 1e-5), (Method.DOPRI8, 1e-6)):
        system, x0, y0, args, y_ref = samples.brusselator_ode()
        params = Params(method)
        params.set_tolerances(1e-8, 1e-8)
        sol = OdeSolver(params, system, "cpu")
        y = sol.solve(y0, x0, 20.0, args=args)
        np.testing.assert_allclose(y.numpy(), y_ref, atol=atol)


@pytest.mark.parametrize("method", ["RADAU5", "BW_EULER"])
def test_dense_route_brusselator_matches_reference(method):
    # the default genie AUTO routes the npoint-5 Brusselator (ndim 50) to
    # DENSE in both packages, with the grid hint. BwEuler's Newton does
    # not converge in 7 iterations at the default equal step 0.1, in
    # either package: it takes 0.05
    jsystem, t0, y0, _ = jsamples.brusselator_pde(2e-3, 5)
    system, *_ = samples.brusselator_pde(2e-3, 5)
    h_equal = 0.05 if method == "BW_EULER" else None
    jsol = JOdeSolver(JParams(JMethod[method]), jsystem)
    yj = np.asarray(jsol.solve(y0, t0, 1.0, h_equal=h_equal))
    sol = OdeSolver(Params(Method[method]), system, "cpu")
    y = sol.solve(y0, t0, 1.0, h_equal=h_equal).numpy()
    assert sol.actual.plan.genie == Genie.DENSE
    assert jsol.actual.plan.genie.value == "dense"
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(y, yj, rtol=1e-12)


def test_bweuler_numerical_jacobian_and_modified_newton():
    # n_function counts ndim per numerical Jacobian (euler.py:128); the
    # modified Newton factorizes in the first step only
    jsystem, t0, y0, _ = jsamples.brusselator_pde(2e-3, 4)
    system, *_ = samples.brusselator_pde(2e-3, 4)
    for numerical, modified in ((True, False), (False, True)):
        params, jparams = Params(Method.BW_EULER), JParams(JMethod.BW_EULER)
        for p in (params, jparams):
            p.newton.use_numerical_jacobian = numerical
            p.bweuler.use_modified_newton = modified
        sol = OdeSolver(params, system, "cpu")
        jsol = JOdeSolver(jparams, jsystem)
        y = sol.solve(y0, t0, 0.05, h_equal=0.01).numpy()
        yj = np.asarray(jsol.solve(y0, t0, 0.05, h_equal=0.01))
        st = sol.stats()
        assert _counters(st) == _counters(jsol.stats())
        np.testing.assert_allclose(y, yj, rtol=1e-10)
        if modified:
            assert st.n_factor < st.n_steps
        else:  # one residual per iteration, ndim per Jacobian
            assert st.n_function == (st.n_lin_sol + st.n_steps
                                     + system.ndim * st.n_jacobian)


def test_radau5_writes_matrices_and_stops(tmp_path, monkeypatch):
    # write_matrix_after_nstep_and_stop: J, K_real and K_comp as
    # MatrixMarket files in $TMPDIR/russell_tpu_torch, then an error
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    system, x0, y0, args = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.newton.write_matrix_after_nstep_and_stop = 2
    sol = OdeSolver(params, system, "cpu")
    with pytest.raises(RuntimeError, match="MATRIX FILES GENERATED"):
        sol.solve(y0, x0, 0.3, args=args)
    out = tmp_path / "russell_tpu_torch"
    for name in ("jacobian", "kk_real", "kk_comp"):
        assert (out / f"{name}.mtx").exists()
        assert (out / f"{name}.smat").exists()
    jac, _ = read_matrix_market(str(out / "jacobian.mtx"))
    assert (jac.nrow, jac.nnz) == (3, 7)
    _, kk = read_matrix_market(str(out / "kk_comp.mtx"))
    assert kk.nnz == 10 and np.iscomplexobj(kk.values)
