"""The fused whole-integration loops of russell_tpu_torch on the CPU:
``OdeSolver.solve(..., fused=True)`` for Radau5 and the embedded ERK
methods, and ``solve_batch``.

On the CPU the step attempt runs eagerly, its ``when`` bodies decided on
the host; on the card the same step is one captured CUDA graph
(``tests/test_torch_cuda.py``). Held here: the port's fused path against
its own host-stepped path (counters equal, y and dense stations at the
stated tolerances), the radau5.f oracles of tests/test_ode.py, the
reference package's fused solvers on the same inputs, each lane of a
batch against a single fused solve of that lane, and an audit that the
step reads device values on the host only through ``when``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, samples as jsamples
from russell_tpu.sparse.lin_solver import LinSolParams as JLinSolParams
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples
from russell_tpu_torch.ode import _device_loop
from russell_tpu_torch.sparse.enums import Genie
from russell_tpu_torch.sparse.lin_solver import LinSolParams

torch.set_num_threads(2)

COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")
ERK_COUNTERS = ("n_function", "n_steps", "n_accepted", "n_rejected")


def _counters(st, keys=COUNTERS):
    return {k: getattr(st, k) for k in keys}


def _brusselator_radau5():
    system, x0, y0, args, _ = samples.brusselator_ode()
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-6, 1e-6)
    return system, x0, y0, args, params


def test_radau5_fused_brusselator_matches_host():
    system, x0, y0, args, params = _brusselator_radau5()
    host = OdeSolver(params, system, "cpu")
    yh = host.solve(y0, x0, 5.0, args=args)
    fused = OdeSolver(params, system, "cpu")
    yf = fused.solve(y0, x0, 5.0, fused=True)
    assert _counters(fused.stats()) == _counters(host.stats())
    np.testing.assert_allclose(yf.numpy(), yh.numpy(), rtol=0, atol=1e-12)
    assert abs(fused.stats().h_accepted - host.stats().h_accepted) < 1e-12


def test_radau5_fused_dense_output_and_playback_match_host():
    system, x0, y0, args, params = _brusselator_radau5()
    out_host = Output().set_dense_h_out(0.31).set_dense_recording([0, 1])
    yh = OdeSolver(params, system, "cpu").solve(y0, x0, 5.0, args=args,
                                                output=out_host)
    out_fused = Output().set_dense_h_out(0.31).set_dense_recording([0, 1])
    yf = OdeSolver(params, system, "cpu").solve(y0, x0, 5.0,
                                                output=out_fused, fused=True)
    np.testing.assert_allclose(yf.numpy(), yh.numpy(), rtol=0, atol=1e-12)
    assert out_fused.dense_x() == out_host.dense_x()
    for m in (0, 1):
        np.testing.assert_allclose(out_fused.dense_y(m), out_host.dense_y(m),
                                   rtol=0, atol=1e-12)

    # explicit interior stations, played back through a callback
    stations = [0.5, 1.25, 3.0]
    seen = []

    def cb(stats, h, x, y, args):
        seen.append((float(x), float(y[0])))
        return False

    out2 = (Output().set_dense_x_out(stations).set_dense_callback(cb)
            .set_dense_recording([0]))
    OdeSolver(params, system, "cpu").solve(y0, x0, 5.0, output=out2,
                                           fused=True)
    assert [x for x, _ in seen] == [0.0] + stations + [5.0]
    out3 = Output().set_dense_x_out(stations).set_dense_recording([0])
    OdeSolver(params, system, "cpu").solve(y0, x0, 5.0, args=args,
                                           output=out3)
    np.testing.assert_allclose(out2.dense_y(0), out3.dense_y(0), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose([y for _, y in seen], out3.dense_y(0),
                               rtol=0, atol=1e-12)


def test_radau5_fused_robertson_matches_fortran():
    # radau5.f through a rejected step (tests/test_ode.py:384)
    system, x0, y0, args = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-8, 1e-2)
    sol = OdeSolver(params, system, "cpu")
    y = sol.solve(y0, x0, 0.3, fused=True)
    st = sol.stats()
    assert abs(float(y[0]) - 9.886740138499884E-01) < 1e-15
    assert abs(float(y[1]) - 3.447720471782070E-05) < 1e-15
    assert abs(float(y[2]) - 1.129150894529390E-02) < 1e-15
    assert abs(st.h_accepted - 8.160578540333708E-01) < 1e-10
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected) == (88, 8, 15, 24,
                                                          17, 15, 1)


def test_radau5_fused_dae_mass_matrix():
    system, x0, y0, args, y_fn = samples.simple_system_with_mass_matrix()
    host = OdeSolver(Params(Method.RADAU5), system, "cpu")
    yh = host.solve(y0, x0, 10.0)
    sol = OdeSolver(Params(Method.RADAU5), system, "cpu")
    y = sol.solve(y0, x0, 10.0, fused=True)
    np.testing.assert_allclose(y.numpy(), y_fn(10.0, None), atol=1e-3)
    assert _counters(sol.stats()) == _counters(host.stats())
    np.testing.assert_allclose(y.numpy(), yh.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["DOPRI5", "DOPRI8", "FEHLBERG4",
                                    "VERNER6"])
def test_erk_fused_matches_host(method):
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    params = Params(Method[method])
    params.step.h_ini = 1e-4
    host = OdeSolver(params, system, "cpu")
    yh = host.solve(y0, x0, 2.0)
    fused = OdeSolver(params, system, "cpu")
    yf = fused.solve(y0, x0, 2.0, fused=True)
    assert (_counters(fused.stats(), ERK_COUNTERS)
            == _counters(host.stats(), ERK_COUNTERS))
    assert abs(fused.stats().h_accepted - host.stats().h_accepted) < 1e-8
    # the host path's cos(x) is the C library's, the fused path's torch's
    np.testing.assert_allclose(yf.numpy(), yh.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", ["DOPRI5", "DOPRI8"])
def test_erk_fused_dense_output_matches_host(method):
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    params = Params(Method[method])
    params.step.h_ini = 1e-4
    out_host = Output().set_dense_h_out(0.23).set_dense_recording([0])
    host = OdeSolver(params, system, "cpu")
    yh = host.solve(y0, x0, 2.0, output=out_host)
    out_fused = Output().set_dense_h_out(0.23).set_dense_recording([0])
    fused = OdeSolver(params, system, "cpu")
    yf = fused.solve(y0, x0, 2.0, output=out_fused, fused=True)
    assert (_counters(fused.stats(), ERK_COUNTERS)
            == _counters(host.stats(), ERK_COUNTERS))
    assert out_fused.dense_x() == out_host.dense_x()
    np.testing.assert_allclose(out_fused.dense_y(0), out_host.dense_y(0),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(yf.numpy(), yh.numpy(), rtol=0, atol=1e-10)


def test_radau5_fused_gridmf_matches_reference():
    # the reference package's fused Radau5 through GRIDMF (its default
    # route above dense_threshold) on the npoint-5 Brusselator
    npoint = 5
    jsystem, t0, y0, _ = jsamples.brusselator_pde(2e-3, npoint)
    jparams = JParams(JMethod.RADAU5)
    jparams.newton.lin_sol_params = JLinSolParams(dense_threshold=8)
    jsol = JOdeSolver(jparams, jsystem)
    yj = np.asarray(jsol.solve(y0, t0, 1.0, fused=True))

    system, t0, y0t, _ = samples.brusselator_pde(2e-3, npoint)
    params = Params(Method.RADAU5)
    params.newton.lin_sol_params = LinSolParams(dense_threshold=8)
    sol = OdeSolver(params, system, "cpu")
    yt = sol.solve(y0t, t0, 1.0, fused=True).numpy()
    assert sol.actual.plan.genie == Genie.GRIDMF
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)
    # and the port's own host-stepped GRIDMF run
    host = OdeSolver(params, system, "cpu")
    yh = host.solve(y0t, t0, 1.0).numpy()
    assert _counters(host.stats()) == _counters(sol.stats())
    np.testing.assert_allclose(yt, yh, rtol=0, atol=1e-12)


def test_dopri8_fused_matches_reference():
    jsystem, x0, y0, _, _ = jsamples.hairer_wanner_eq1()
    jparams = JParams(JMethod.DOPRI8)
    jparams.step.h_ini = 1e-4
    jsol = JOdeSolver(jparams, jsystem)
    yj = np.asarray(jsol.solve(y0, x0, 2.0, fused=True))
    system, *_ = samples.hairer_wanner_eq1()
    params = Params(Method.DOPRI8)
    params.step.h_ini = 1e-4
    sol = OdeSolver(params, system, "cpu")
    yt = sol.solve(y0, x0, 2.0, fused=True).numpy()
    assert (_counters(sol.stats(), ERK_COUNTERS)
            == _counters(jsol.stats(), ERK_COUNTERS))
    # the reference's jitted kernels contract multiply-adds (PERF.md §6)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10)


def _lane_matches_single(sol, y0s, b, ys, st, x0, x1, keys):
    y = sol.solve(y0s[b], x0, x1, fused=True)
    np.testing.assert_allclose(ys[b].numpy(), y.numpy(), rtol=0, atol=1e-12)
    single = _counters(sol.stats(), keys)
    assert {k: int(st[k][b]) for k in keys} == single, b


def test_radau5_solve_batch_lanes_equal_single_solves():
    system, x0, y0, x1, args = samples.van_der_pol(1e-4, False)
    sol = OdeSolver(Params(Method.RADAU5), system, "cpu")
    B = 8
    y0s = np.tile(np.asarray(y0)[None, :], (B, 1))
    y0s[:, 0] += np.linspace(-0.2, 0.2, B)
    ys, st = sol.solve_batch(y0s, x0, 1.0)
    assert ys.shape == (B, 2)
    assert sol.actual.plan.genie == Genie.DENSE
    assert st["status"].tolist() == [1] * B
    # independent controllers: the lanes take different step counts
    assert len(set(st["n_accepted"].tolist())) > 1
    for b in range(B):
        _lane_matches_single(sol, y0s, b, ys, st, x0, 1.0, COUNTERS)


def test_erk_solve_batch_lanes_equal_single_solves():
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    params = Params(Method.DOPRI5)
    params.step.h_ini = 1e-4
    sol = OdeSolver(params, system, "cpu")
    y0s = np.linspace(0.5, 2.0, 8)[:, None] * np.asarray(y0)[None, :]
    y0s[:, 0] += np.linspace(0.0, 0.7, 8)
    ys, st = sol.solve_batch(y0s, x0, 1.5)
    assert ys.shape == (8, 1)
    assert st["status"].tolist() == [1] * 8
    assert len(set(st["n_steps"].tolist())) > 1
    for b in range(8):
        _lane_matches_single(sol, y0s, b, ys, st, x0, 1.5, ERK_COUNTERS)


def test_capture_refusal_reads_the_warm_up():
    # what DeviceLoop.capture checks before it captures: the warm-up's
    # reservation and the spare against the card's free memory, and
    # whether the warm-up had to return cached memory to fit
    gib = 2 ** 30
    spare = _device_loop.CAPTURE_SPARE_BYTES
    assert _device_loop.capture_refusal(30 * gib, 0, 30 * gib + spare,
                                        80 * gib) is None
    why = _device_loop.capture_refusal(30 * gib, 0, 31 * gib, 80 * gib)
    assert "about 30.0 GiB" in why and "31.0 GiB of the card's 80.0" in why
    why = _device_loop.capture_refusal(gib, 2, 70 * gib, 80 * gib)
    assert "returning cached memory (2 times)" in why


def test_replay_count_does_not_change_the_bits(monkeypatch):
    # the counterpart of tests/test_ode.py:456: reading the done flag after
    # every attempt or after every 8 gives the same bits
    system, x0, y0, args, params = _brusselator_radau5()
    runs = []
    for n in (1, 8):
        monkeypatch.setattr(_device_loop, "REPLAYS_PER_READ", n)
        sol = OdeSolver(params, system, "cpu")
        y = sol.solve(y0, x0, 5.0, fused=True)
        loop = sol._fused[(1, None)].loop
        runs.append((y.numpy().tobytes(), _counters(sol.stats()),
                     sol.stats().h_accepted, loop.reads))
    assert runs[0][:3] == runs[1][:3]
    assert runs[0][3] > runs[1][3]


class _HostReads(TorchDispatchMode):
    """Counts aten._local_scalar_dense, the op behind .item(), float() and
    bool() of a tensor."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["radau5_gridmf", "radau5_lanes",
                                  "dopri8_dense"])
def test_step_reads_the_device_only_through_when(case):
    if case == "dopri8_dense":
        system, x0, y0, args, _ = samples.hairer_wanner_eq1()
        params = Params(Method.DOPRI8)
        sol = OdeSolver(params, system, "cpu")
        fn = sol._build_fused(1, np.linspace(0.0, 1.0, 5))
        y0s, x1 = torch.as_tensor(np.asarray(y0))[None], 1.0
    else:
        npoint = 5
        system, x0, y0, _ = samples.brusselator_pde(2e-3, npoint)
        params = Params(Method.RADAU5)
        params.newton.lin_sol_params = LinSolParams(dense_threshold=8)
        lanes = 1
        if case == "radau5_lanes":
            params.newton.genie = Genie.DENSE
            lanes = 3
        sol = OdeSolver(params, system, "cpu")
        fn = sol._build_fused(lanes)
        y0s = torch.as_tensor(np.asarray(y0)).repeat(lanes, 1)
        y0s[:, 0] += torch.linspace(0.0, 0.2, lanes, dtype=torch.float64)
        x1 = 1.0
    fn.start(x0, y0s, x1, min(params.step.h_ini, x1 - x0))
    before = _device_loop.host_reads
    with _HostReads() as reads:
        for _ in range(6):  # first step, rejects, accepts, factor reuse
            fn._attempt()
    assert int(fn.s["n_accepted"].min()) >= 1
    assert reads.n == _device_loop.host_reads - before > 0


@pytest.mark.parametrize("what", ["h_equal", "args", "step_output",
                                  "no_dense", "erk_dense", "bwd_euler"])
def test_fused_refusals_match_reference(what):
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    method = {"erk_dense": Method.FEHLBERG4,
              "bwd_euler": Method.BW_EULER}.get(what, Method.RADAU5)
    sol = OdeSolver(Params(method), system, "cpu")
    kw = {"h_equal": {"h_equal": 0.1}, "args": {"args": 1.0},
          "step_output": {"output": Output().set_step_recording([0])},
          "no_dense": {"output": Output()},
          "erk_dense": {"output": Output().set_dense_h_out(0.1)
                        .set_dense_recording([0])},
          "bwd_euler": {}}[what]
    with pytest.raises(ValueError):
        sol.solve(y0, x0, x1, fused=True, **kw)
