"""Solve the reference umfpack 5x5 sample with every native genie
(mirrors russell_sparse examples/doc_umfpack_quickstart.rs).

Usage: python examples_torch/ex_sparse_solve_small.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import Genie, LinSolver, VerifyLinSys, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

coo, _, _, det = samples.umfpack_unsymmetric_5x5(device)
rhs = np.array([8.0, 45.0, -3.0, 3.0, 19.0])
for genie in (Genie.DENSE, Genie.BANDED, Genie.SPLU):
    solver = LinSolver(genie, device=device)
    solver.factorize(coo)
    x = solver.solve(rhs).cpu().numpy()
    v = VerifyLinSys.from_system(coo, x, rhs)
    print(f"{genie.value:>6}: x = {np.round(x, 6)} "
          f"rel_err = {v.relative_error:.2e}")
    assert v.relative_error < 1e-12
print("ok")
