"""russell_tpu_torch never imports jax (nor russell_tpu), and neither do
chip_smoke.py and gj_inv_variants.py."""

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
            "russell_tpu_torch.sparse.matrix_market",
            "russell_tpu_torch.sparse.gridmf",
            "russell_tpu_torch.sparse.numerical_jacobian",
            "russell_tpu_torch.ode.erk", "russell_tpu_torch.ode.erk_dense_out",
            "russell_tpu_torch.ode.euler", "russell_tpu_torch.ode.output",
            "russell_tpu_torch.ode.detect_stiffness",
            "russell_tpu_torch.ode.samples",
            "russell_tpu_torch.ode.system",
            "russell_tpu_torch.ode._device_loop",
            "russell_tpu_torch.ode.radau5_fused",
            "russell_tpu_torch.ode.erk_fused",
            "russell_tpu_torch.sparse.bcr", "russell_tpu_torch.sparse.genmf",
            "russell_tpu_torch.sparse.lin_solver",
            "russell_tpu_torch.sparse.ordering",
            "russell_tpu_torch.bin",
            "russell_tpu_torch.bin.solve_matrix_market",
            "russell_tpu_torch.math", "russell_tpu_torch.math.chebyshev",
            "russell_tpu_torch.algo", "russell_tpu_torch.algo.interp_lagrange",
            "russell_tpu_torch.algo.misc", "russell_tpu_torch.pde",
            "russell_tpu_torch.pde.enums", "russell_tpu_torch.pde.grid",
            "russell_tpu_torch.pde.bcs",
            "russell_tpu_torch.pde.equation_handler",
            "russell_tpu_torch.pde.fdm", "russell_tpu_torch.pde.spc",
            "russell_tpu_torch.pde.spc_map", "russell_tpu_torch.pde.metrics",
            "russell_tpu_torch.pde.transfinite",
            "russell_tpu_torch.pde.problem_samples",
            "russell_tpu_torch.nonlin", "russell_tpu_torch.nonlin.config",
            "russell_tpu_torch.nonlin.system", "russell_tpu_torch.nonlin.stats",
            "russell_tpu_torch.nonlin.logger",
            "russell_tpu_torch.nonlin.output",
            "russell_tpu_torch.nonlin.solvers",
            "russell_tpu_torch.nonlin.solver",
            "russell_tpu_torch.nonlin.samples",
            "russell_tpu_torch.core", "russell_tpu_torch.core._place",
            "russell_tpu_torch.core.check", "russell_tpu_torch.core.enums",
            "russell_tpu_torch.core.formatters",
            "russell_tpu_torch.core.generators",
            "russell_tpu_torch.core.peaks", "russell_tpu_torch.core.read_table",
            "russell_tpu_torch.core.sort", "russell_tpu_torch.core.stopwatch",
            "russell_tpu_torch.math._coeffs", "russell_tpu_torch.math.basic",
            "russell_tpu_torch.math.bessel",
            "russell_tpu_torch.math.constants",
            "russell_tpu_torch.math.elliptic",
            "russell_tpu_torch.math.legendre", "russell_tpu_torch.dense",
            "russell_tpu_torch.dense.vector_ops",
            "russell_tpu_torch.dense.matvec_ops",
            "russell_tpu_torch.dense.matrix_ops",
            "russell_tpu_torch.algo.stats",
            "russell_tpu_torch.algo.interp_chebyshev",
            "russell_tpu_torch.algo.root_finder",
            "russell_tpu_torch.algo.minimize",
            "russell_tpu_torch.algo.quadrature",
            "russell_tpu_torch.algo.newton_solver"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke, gj_inv_variants\n"
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
