"""The port's bin/ CLIs and utils/ against russell_tpu's, on the CPU.

``tests/test_cli.py:32-51`` is the checklist. Each CLI runs in-process
(``main(argv)``) in both packages on the same small problem, the port with
``--device cpu``: the Radau5 counters printed by ``Stats.summary`` are
equal, the printed y within rtol 1e-10 (the last printed digit). The
reference's ``mem_check`` is not run here (it compiles for ~30 s on the
CPU); the port's must exit 0. A checkpoint written by either package loads
in the other, the port's step callback snapshots a Radau5 run, and
``trace(..., device="cpu")`` writes a trace file.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import cli_report
from russell_tpu.bin import amplifier1t as jamp
from russell_tpu.bin import brusselator_pde as jbrus
from russell_tpu.utils import CheckpointManager as JCheckpoint
from russell_tpu_torch.bin import amplifier1t, brusselator_pde, mem_check
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples
from russell_tpu_torch.utils import CheckpointManager, trace

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return cli_report(capsys.readouterr().out)


def _hold(got, want):
    assert got["counters"] == want["counters"]
    assert len(got["counters"]) == 9
    assert got["h_accepted"] == pytest.approx(want["h_accepted"], rel=1e-10)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-10, atol=0)


def test_brusselator_pde_cli_matches_reference(capsys):
    argv = ["--npoint", "9", "--tol", "1e-4", "--tf", "0.2"]
    want = _run(jbrus.main, argv, capsys)
    got = _run(brusselator_pde.main, argv + ["--device", CPU], capsys)
    _hold(got, want)
    assert got["head"] == want["head"]
    assert got["finite"] is True
    # the host-stepped integration takes the same steps
    _hold(_run(brusselator_pde.main, argv + ["--device", CPU, "--no-fused"],
               capsys), want)


def test_amplifier1t_cli_matches_reference(capsys):
    argv = ["--tf", "0.002"]
    want = _run(jamp.main, argv, capsys)
    got = _run(amplifier1t.main, argv + ["--device", CPU], capsys)
    _hold(got, want)
    assert len(got["y"]) == 5


def test_mem_check_cli_passes_on_the_cpu(capsys):
    assert mem_check.main(["--device", CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    ok = [ln for ln in lines if ln.startswith("OK ")]
    assert len(ok) == 21      # 7 cases x DENSE, BANDED, SPLU
    assert lines[-1] == "0 failures"


def test_checkpoints_load_in_either_package(tmp_path):
    y = np.random.default_rng(3).standard_normal(7)
    ours = CheckpointManager(str(tmp_path / "a" / "port.npz"))
    ours.save(0.25, torch.as_tensor(y), 1e-3, {"n_accepted": 4})
    assert ours.exists()
    x, yj, h, meta = JCheckpoint(ours.path).load()
    assert (x, h, meta) == (0.25, 1e-3, {"n_accepted": 4})
    np.testing.assert_array_equal(yj, y)
    theirs = JCheckpoint(str(tmp_path / "ref.npz"))
    theirs.save(0.5, y[::-1], 2e-3)
    x, yp, h, meta = CheckpointManager(theirs.path).load()
    assert (x, h, meta) == (0.5, 2e-3, {})
    np.testing.assert_array_equal(yp, y[::-1])
    assert sorted(os.listdir(tmp_path / "a")) == ["port.npz"]


def test_checkpoint_step_callback_snapshots_a_radau5_run(tmp_path):
    system, x0, y0, _, _ = samples.van_der_pol(1e-6)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    ck = CheckpointManager(str(tmp_path / "vdp.npz"))
    inner = ck.as_step_callback(every_n=4)
    seen = []

    def cb(stats, h, x, y, args):
        seen.append((x, np.array(y), h, stats.n_accepted))
        return inner(stats, h, x, y, args)

    solver = OdeSolver(params, system, device=CPU)
    solver.solve(y0, x0, 0.2, output=Output().set_step_callback(cb))
    assert len(seen) >= 12
    x, y, h, meta = ck.load()
    last = seen[len(seen) // 4 * 4 - 1]
    assert (x, h, meta["n_accepted"]) == (last[0], last[2], last[3])
    np.testing.assert_array_equal(y, last[1])


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path), device=CPU) as prof:
        (torch.ones(64, dtype=torch.float64) * 2.0).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    assert prof.key_averages()
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError):
            with trace(str(tmp_path / "card")):
                pass
        with pytest.raises(RuntimeError):
            mem_check.main([])
