"""Output of russell_tpu_torch (step and dense output, callbacks, JSON files,
stiffness recording) against russell_tpu's, on the CPU.

The same problem goes through both packages with the same Output
settings; the stations, the recorded steps and the files must be the
reference's, with the same counters. The reference's jitted kernels
contract multiply-adds into FMAs, which eager torch ops do not, so an
error estimate that is mostly cancellation differs in its last bits and
the step sizes that follow from it differ by up to ~1e-11 relative
(PERF.md §6): step x, h and the y that follow are held at rtol 1e-10,
with an atol of 1e-10 of the largest |y| for components near zero; the
dense stations at 1e-12 (DoPri8 on Hairer-Wanner eq. 1: 1e-10).
"""

import json

import numpy as np
import pytest
import torch

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Output as JOutput, Params as JParams
from russell_tpu.ode import samples as jsamples
from russell_tpu_torch.ode import (Method, OdeSolver, OutCount, OutData,
                                   Output, Params, StiffnessError, samples)

torch.set_num_threads(2)


def _close(got, want, tol=1e-10):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.max(np.abs(want)))


def _pair(sample, method, setup=None, **sample_kw):
    """(the port's solver, the reference's solver, the port's sample tuple)
    for ``sample``, both with h_ini 1e-4 and ``setup(params)`` applied."""
    jres = getattr(jsamples, sample)(**sample_kw)
    tres = getattr(samples, sample)(**sample_kw)
    params, jparams = Params(method), JParams(JMethod[method.name])
    for p in (params, jparams):
        p.step.h_ini = 1e-4
        if setup is not None:
            setup(p)
    return (OdeSolver(params, tres[0], "cpu"), JOdeSolver(jparams, jres[0]),
            tres)


@pytest.mark.parametrize("method", ["DOPRI5", "DOPRI8", "RADAU5"])
def test_dense_output_matches_reference(method):
    sol, jsol, (_, x0, y0, _, _) = _pair("hairer_wanner_eq1", Method[method])
    out = Output().set_dense_h_out(0.1).set_dense_recording([0])
    jout = JOutput().set_dense_h_out(0.1).set_dense_recording([0])
    sol.solve(y0, x0, 1.5, output=out)
    jsol.solve(y0, x0, 1.5, output=jout)
    assert out.dense_x() == jout.dense_x() and len(out.dense_x()) == 16
    # DoPri8's dense coefficients reach ~500 and cancel, so the FMAs'
    # last bits reach 8e-12 of max|y| there; the others stay within 2e-14
    _close(out.dense_y(0), jout.dense_y(0),
           1e-10 if method == "DOPRI8" else 1e-12)
    assert sol.stats().n_function == jsol.stats().n_function


def test_dense_output_on_a_system_matches_reference():
    # DoPri8's three extra stages and DoPri5's polynomial on a 2-dim
    # system, explicit interior stations
    for method in (Method.DOPRI5, Method.DOPRI8):
        sol, jsol, (_, x0, y0, _, _) = _pair("kreyszig_ex4_page920", method)
        stations = [0.05, 0.33, 0.7]
        out = Output().set_dense_x_out(stations).set_dense_recording([0, 1])
        jout = JOutput().set_dense_x_out(stations).set_dense_recording([0, 1])
        sol.solve(y0, x0, 1.0, output=out)
        jsol.solve(y0, x0, 1.0, output=jout)
        assert out.dense_x() == jout.dense_x() == [0.0] + stations + [1.0]
        for m in (0, 1):
            _close(out.dense_y(m), jout.dense_y(m), 1e-12)


def test_dense_output_dopri5_kreyszig():
    # tests/test_ode.py:149
    system, x0, y0, args, y_fn = samples.kreyszig_eq6_page902()
    sol = OdeSolver(Params(Method.DOPRI5), system, "cpu")
    out = Output().set_dense_h_out(0.1).set_dense_recording([0])
    sol.solve(y0, x0, 1.0, args=args, output=out)
    for x, yv in zip(out.dense_x(), out.dense_y(0)):
        assert abs(yv - float(y_fn(x, None)[0])) < 1e-5


def test_radau5_dense_output_hairer_wanner():
    # tests/test_ode.py:160
    system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()
    sol = OdeSolver(Params(Method.RADAU5), system, "cpu")
    out = Output().set_dense_h_out(0.25).set_dense_recording([0])
    sol.solve(y0, x0, 1.5, args=args, output=out)
    for x, yv in zip(out.dense_x()[1:], out.dense_y(0)[1:]):
        assert abs(yv - float(y_fn(x, None)[0])) < 1e-3


def test_step_recording_matches_reference():
    sol, jsol, (_, x0, y0, _, y_fn) = _pair("kreyszig_ex4_page920",
                                            Method.DOPRI5)
    out = Output().set_step_recording([1]).set_yx_correct(y_fn)
    jout = JOutput().set_step_recording([1]).set_yx_correct(y_fn)
    sol.solve(y0, x0, 1.0, output=out)
    jsol.solve(y0, x0, 1.0, output=jout)
    np.testing.assert_allclose(out.step_x, jout.step_x, rtol=1e-10)
    np.testing.assert_allclose(out.step_h, jout.step_h, rtol=1e-10)
    assert len(out.step_x) > 2 and out.step_y(0) == []
    _close(out.step_y(1), jout.step_y(1))
    np.testing.assert_allclose(out.step_global_error,
                               jout.step_global_error, rtol=1e-9,
                               atol=1e-15)
    assert max(out.step_global_error) < 1e-4


def test_step_callback_stops_like_reference():
    # tests/test_ode.py:169: a True return stops the integration
    seen = {}
    for pkg, make in (("torch", Output), ("jax", JOutput)):
        calls = []

        def cb(stats, h, x, y, args, calls=calls):
            assert isinstance(y, np.ndarray) and y.shape == (2,)
            calls.append((x, float(y[0])))
            return x > 0.5

        sol, jsol, (_, x0, y0, _, _) = _pair("kreyszig_ex4_page920",
                                             Method.DOPRI5)
        s = sol if pkg == "torch" else jsol
        y = s.solve(y0, x0, 1.0, output=make().set_step_callback(cb))
        seen[pkg] = (calls, np.asarray(y), s.stats().n_accepted)
    calls, y, n_acc = seen["torch"]
    jcalls, jy, jn_acc = seen["jax"]
    assert 0.5 < calls[-1][0] < 1.0 and n_acc == jn_acc
    np.testing.assert_allclose([c[0] for c in calls],
                               [c[0] for c in jcalls], rtol=1e-10)
    _close([c[1] for c in calls], [c[1] for c in jcalls])
    _close(y, jy)


def test_dense_callback_stop():
    stops = []

    def cb(stats, h, x, y, args):
        stops.append(x)
        return len(stops) == 3

    sol, _, (_, x0, y0, _, _) = _pair("kreyszig_eq6_page902", Method.DOPRI5)
    out = Output().set_dense_h_out(0.1).set_dense_callback(cb)
    sol.solve(y0, x0, 1.0, output=out)
    assert stops == pytest.approx([0.0, 0.1, 0.2])


def test_json_files_match_reference(tmp_path):
    files = {}
    for pkg, make in (("torch", Output), ("jax", JOutput)):
        sol, jsol, (_, x0, y0, _, _) = _pair("kreyszig_ex4_page920",
                                             Method.DOPRI5)
        d = tmp_path / pkg
        out = (make().set_step_file_writing(str(d / "step"))
               .set_dense_h_out(0.25)
               .set_dense_file_writing(str(d / "dense")))
        (sol if pkg == "torch" else jsol).solve(y0, x0, 1.0, output=out)
        files[pkg] = d
    for key in ("step", "dense"):
        n = OutCount.read_json(str(files["torch"] / f"{key}_count.json")).n
        assert n == OutCount.read_json(
            str(files["jax"] / f"{key}_count.json")).n
        assert n == (5 if key == "dense" else n) and n > 2
        for i in range(n):
            got = OutData.read_json(str(files["torch"] / f"{key}_{i}.json"))
            with open(files["jax"] / f"{key}_{i}.json") as f:
                want = json.load(f)
            np.testing.assert_allclose([got.x, got.h], [want["x"], want["h"]],
                                       rtol=1e-10)
            _close(got.y, want["y"])


def test_stiffness_detection_raises():
    # tests/test_ode.py:224: van der Pol eps 0.003 turns stiff for DoPri5
    system, x0, y0, x1, args = samples.van_der_pol(0.003, False)
    params = Params(Method.DOPRI5)
    params.set_tolerances(1e-5, 1e-5)
    params.stiffness.enabled = True
    sol = OdeSolver(params, system, "cpu")
    with pytest.raises(StiffnessError):
        sol.solve(y0, x0, 2.0, args=args)


def _stiff_params(p):
    p.set_tolerances(1e-5, 1e-5)
    p.stiffness.enabled = True
    p.stiffness.stop_with_error = False
    p.stiffness.save_results = True


def test_stiffness_recording_matches_reference():
    # DoPri5 on van der Pol eps 0.003 (tests/test_ode.py:224) recording
    # its detections instead of stopping
    sol, jsol, (_, x0, y0, _, _) = _pair("van_der_pol", Method.DOPRI5,
                                         setup=_stiff_params, epsilon=0.003)
    out, jout = Output(), JOutput()
    y = sol.solve(y0, x0, 1.0, output=out).numpy()
    yj = np.asarray(jsol.solve(y0, x0, 1.0, output=jout))
    st, jst = sol.stats(), jsol.stats()
    assert (st.n_function, st.n_steps, st.n_accepted, st.n_rejected) == (
        jst.n_function, jst.n_steps, jst.n_accepted, jst.n_rejected)
    np.testing.assert_allclose(y, yj, rtol=1e-10)
    assert out.stiff_step_index == jout.stiff_step_index
    assert len(out.stiff_step_index) == 2
    np.testing.assert_allclose(out.stiff_x(), jout.stiff_x(), rtol=1e-8)
    # h·rho is h sqrt(|k7 - k6|² / |v7 - v6|²): both sums are of stage
    # differences, mostly cancellation, so the FMAs reach ~3e-6 of it
    np.testing.assert_allclose(out.stiff_h_times_rho(),
                               jout.stiff_h_times_rho(), rtol=1e-5)


def test_dopri8_stiffness_detection_counts_one_evaluation():
    # DoPri8's h·rho needs f(x+h, w): one more evaluation per accepted
    # step once detection is on, and nothing else changes. (The reference
    # package's counters on this run differ from these by an accept/reject
    # flip at x 0.855, from its kernels' FMAs: PERF.md §6.)
    runs = {}
    for enabled in (False, True):
        def setup(p, enabled=enabled):
            _stiff_params(p)
            p.stiffness.enabled = enabled

        sol, _, (_, x0, y0, _, _) = _pair("van_der_pol", Method.DOPRI8,
                                          setup=setup, epsilon=0.003)
        out = Output()
        y = sol.solve(y0, x0, 1.0, output=out)
        runs[enabled] = (sol.stats(), y, out)
    (st0, y0_, _), (st1, y1, out) = runs[False], runs[True]
    assert (st1.n_steps, st1.n_accepted) == (st0.n_steps, st0.n_accepted)
    assert st1.n_function == st0.n_function + st1.n_accepted
    torch.testing.assert_close(y1, y0_, rtol=0, atol=0)
    assert len(out.stiff_h_times_rho()) == st1.n_accepted + 1  # x0 too
    assert len(out.stiff_step_index) > 0 and max(out.stiff_h_times_rho()) > 6.1


def test_dense_output_needs_dopri_or_radau5():
    system, x0, y0, args, _ = samples.kreyszig_eq6_page902()
    for method in (Method.RK4, Method.FW_EULER, Method.BW_EULER):
        sol = OdeSolver(Params(method), system, "cpu")
        with pytest.raises(ValueError, match="dense output"):
            sol.solve(y0, x0, 1.0,
                      output=Output().set_dense_h_out(0.1)
                      .set_dense_recording([0]))
