"""russell_tpu_torch never imports jax (nor russell_tpu), and neither does
chip_smoke.py."""

import os
import pkgutil
import subprocess
import sys

import torch

import russell_tpu_torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = ["russell_tpu_torch"]
    for info in pkgutil.walk_packages(russell_tpu_torch.__path__,
                                      "russell_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_import_without_jax():
    names = _port_modules()
    assert {"russell_tpu_torch.sparse.splu", "russell_tpu_torch.sparse.factor",
            "russell_tpu_torch.sparse._cuda", "russell_tpu_torch.ode.radau5",
            "russell_tpu_torch.ode.solver", "russell_tpu_torch.interop",
            "russell_tpu_torch.native", "russell_tpu_torch.sparse.kernels",
            "russell_tpu_torch.sparse.coo", "russell_tpu_torch.sparse.csr",
            "russell_tpu_torch.sparse.csc", "russell_tpu_torch.sparse.samples",
            "russell_tpu_torch.sparse.verify",
            "russell_tpu_torch.sparse.matrix_market"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'russell_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
