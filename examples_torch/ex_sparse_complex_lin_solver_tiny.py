"""Complex LinSolver doc examples (mirrors russell_sparse/examples/
doc_complex_lin_solver_compute.rs, doc_complex_lin_solver_umfpack_tiny.rs,
doc_complex_umfpack_quickstart_coo.rs, doc_complex_umfpack_tiny.rs).

Usage: python examples_torch/ex_sparse_complex_lin_solver_tiny.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import CooMatrix, Genie, LinSolver, VerifyLinSys

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# tiny complex system with known solution
n = 4
ii = np.asarray([0, 0, 1, 1, 2, 2, 3, 3])
jj = np.asarray([0, 1, 1, 2, 2, 3, 3, 0])
vv = np.asarray([2 + 1j, 1 - 1j, 3 + 0j, 1 + 2j, 4 - 1j, 2 + 0j,
                 5 + 3j, 1 + 0j], dtype=complex)
coo = CooMatrix.from_arrays(n, n, ii, jj, vv)
A = np.asarray(coo.as_dense())
x_true = np.asarray([1 + 1j, 2 - 1j, -1 + 0.5j, 0.5 - 2j])
b = A @ x_true

for genie in (Genie.DENSE, Genie.SPLU):
    solver = LinSolver(genie, device=device)
    solver.factorize(coo)
    x = solver.solve(b).cpu().numpy()
    err = np.max(np.abs(x - x_true))
    print(f"{genie.value}: max|x - x_true| = {err:.2e}")
    assert err < 1e-10
    v = VerifyLinSys.from_system(coo, x, b)
    assert v.relative_error < 1e-12
print("complex lin solver docs OK")
