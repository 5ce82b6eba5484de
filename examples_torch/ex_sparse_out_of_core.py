"""Out-of-core GRIDMF: when the multifrontal factor store exceeds the
device budget (``factor.GRIDMF_BUDGET_GB``), the factors go to host memory
depth by depth and each solve ships them back level by level, the role of
cuDSS's hybrid host/device memory mode and MUMPS's out-of-core factors.
Shown here with the budget cut to almost nothing; a 3-D operator such as
``samples.laplacian_3d(79)`` with the grid hint (79, 79, 79) (49 GiB of f64
factors) is the real use.

Usage: python examples_torch/ex_sparse_out_of_core.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                      VerifyLinSys, factor, gridmf, samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

budget = factor.GRIDMF_BUDGET_GB
factor.GRIDMF_BUDGET_GB = 1e-9          # force out of core
try:
    coo = samples.laplacian_2d(32)
    sol = LinSolver(Genie.GRIDMF, device=device)
    sol.factorize(coo, LinSolParams(grid=(32, 32, 1)))
    assert sol.stats.output.get("out_of_core") is True

    # every level's factors live in host memory, not on the device
    levels = sol.fac["levels"]
    assert isinstance(levels, gridmf.HostLevels)
    assert all(t.device.type == "cpu" for st in levels for t in st.values()
               if t is not None)
    tot = sum(t.numel() * t.element_size() for st in levels
              for t in st.values() if t is not None)
    print(f"host-resident factor store: {tot / 2 ** 20:.2f} MiB "
          f"over {len(levels)} levels")

    b = np.linspace(1.0, 2.0, coo.nrow)
    x = sol.solve(b)
    v = VerifyLinSys.from_system(coo, x, b)
    print("relative_error =", v.relative_error)
    assert v.relative_error < 1e-10

    mant, base, expo = sol.determinant()
    sign, logabs = np.linalg.slogdet(coo.as_dense())
    assert np.sign(mant) == sign
    assert abs(expo + np.log10(abs(mant)) - logabs / np.log(10)) < 1e-7
finally:
    factor.GRIDMF_BUDGET_GB = budget
print("out-of-core gridmf OK")
