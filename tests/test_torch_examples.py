"""The port's examples against the reference package's.

Every ``examples/ex_*.py`` has its counterpart in ``examples_torch/``,
which computes what the reference example computes at its sizes and
prints the same lines. The reference's output was recorded by
``tests/make_examples_reference.py`` (JAX on the CPU in float64, as
``examples/run_all.sh`` runs it: far too slow to run live here) into
``tests/data/examples_reference.json``.

One subprocess runs all the port's examples with ``--device cpu`` on one
intra-op thread, with jax, jaxlib and russell_tpu refused at import
(``examples_torch/_run.py``). Each example's case holds that it ran,
that it left the package's settings as it found them, and that its
output matches the reference's under ``examples_torch/_stdout.py``
(numbers within 1e-9 relative or half a unit of the last printed digit,
integers exact, durations masked; the listed exceptions compare the
text of the named lines with their numbers masked).
"""

import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples_torch import _stdout  # noqa: E402

REFERENCE = os.path.join(ROOT, "tests", "data", "examples_reference.json")
NAMES = sorted(os.path.basename(p) for p in
               glob.glob(os.path.join(ROOT, "examples", "ex_*.py")))
MAIN_PATH = ("ex_ode_brusselator_pde_radau5.py", "ex_sparse_poisson_3d.py")
RUN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as fh:
        return json.load(fh)["examples"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Every port example once, in one subprocess: the records by name
    and the refused modules that got loaded (an empty run when the
    subprocess fails or outlasts its timeout)."""
    out = str(tmp_path_factory.mktemp("examples") / "records.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    try:
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples_torch", "_run.py"),
             "--device", "cpu", "--out", out], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        failure = None if res.returncode == 0 else res.stderr[-3000:]
    except subprocess.TimeoutExpired:
        failure = f"the examples outlasted {RUN_TIMEOUT_S} s"
    if failure is not None:
        return {"records": {}, "refused": None, "failure": failure}
    with open(out) as fh:
        run = json.load(fh)
    return {"records": {r["name"]: r for r in run["records"]},
            "refused": run["refused_modules_loaded"], "failure": None}


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_reference(name, reference, port_run):
    assert port_run["failure"] is None, port_run["failure"]
    rec = port_run["records"].get(name)
    assert rec is not None, f"examples_torch/{name} is missing"
    assert rec["error"] is None, rec["error"]
    assert rec["changed_settings"] == [], rec["changed_settings"]
    ref = reference[name]
    if ref["returncode"] != 0:
        # the reference cannot run here: the port's own asserts hold it
        assert name in _stdout.EXCEPTIONS, ref["returncode"]
        assert rec["stdout"].splitlines()[-1] == "ok"
        return
    diffs = _stdout.compare(ref["stdout"], rec["stdout"], name)
    assert not diffs, "\n".join(diffs)


def test_examples_run_without_jax_and_exceptions_have_reasons(port_run):
    assert port_run["failure"] is None, port_run["failure"]
    assert port_run["refused"] == []
    assert set(port_run["records"]) == set(NAMES)
    for name, (reason, pattern) in _stdout.EXCEPTIONS.items():
        assert name in NAMES and len(reason) > 20, name
    assert not set(MAIN_PATH) & set(_stdout.EXCEPTIONS)
