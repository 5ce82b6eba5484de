"""LinSolver quickstart on the reference tiny doc system (mirrors
russell_sparse/examples/doc_lin_solver_compute.rs,
doc_lin_solver_umfpack_tiny.rs, doc_umfpack_quickstart_coo.rs,
doc_umfpack_tiny.rs, mumps_solve_small.rs: the classic UMFPACK 5x5
demo with x = [1,2,3,4,5]).

Usage: python examples_torch/ex_sparse_lin_solver_tiny.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import (CooMatrix, Genie, LinSolParams,
                                      LinSolver, VerifyLinSys)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

ii = [0, 0, 1, 1, 1, 2, 2, 2, 3, 4, 4, 4]
jj = [0, 1, 0, 2, 4, 1, 2, 3, 2, 1, 2, 4]
vv = [2.0, 3.0, 3.0, 4.0, 6.0, -1.0, -3.0, 2.0, 1.0, 4.0, 2.0, 1.0]
coo = CooMatrix.from_arrays(5, 5, np.asarray(ii), np.asarray(jj),
                            np.asarray(vv, dtype=float))
A = np.asarray(coo.as_dense())
b = np.asarray([8.0, 45.0, -3.0, 3.0, 19.0])
det_ref = np.linalg.det(A)

for genie in (Genie.DENSE, Genie.SPLU):
    solver = LinSolver(genie, device=device)
    solver.factorize(coo, LinSolParams(compute_determinant=True))
    x = solver.solve(b).cpu().numpy()
    assert np.allclose(x, [1.0, 2.0, 3.0, 4.0, 5.0], atol=1e-10), (genie, x)
    v = VerifyLinSys.from_system(coo, x, b)
    m, base, expo = solver.determinant()
    det = float(np.real(m)) * base ** expo
    print(f"{genie.value}: x = {np.round(x, 10)}, rel_err = "
          f"{v.relative_error:.2e}, det = {det:.6f} (ref {det_ref:.6f})")
    assert v.relative_error < 1e-14
    assert abs(det - det_ref) < 1e-8 * abs(det_ref)
print("lin solver tiny docs OK")
