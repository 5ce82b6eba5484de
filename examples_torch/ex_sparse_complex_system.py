"""Complex sparse linear system through every native genie
(mirrors russell_sparse examples/complex_system.rs: the AC circuit
system from Intel oneAPI complex example).

Usage: python examples_torch/ex_sparse_complex_system.py [--device cuda|cpu]
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

# 8x8 complex unsymmetric system (complex_system.rs:1-60)
n = 8
coo = CooMatrix(n, n, 64, dtype=np.complex128)
entries = [
    (0, 0, 19.73, 0.0), (0, 1, 12.11, -1.0),
    (1, 0, 0.0, -0.51), (1, 1, 32.3, 7.0), (1, 2, 23.07, 0.0),
    (2, 1, 0.0, 1.1), (2, 2, 70.0, 7.3), (2, 3, 3.95, 0.0),
    (3, 2, 1.0, 1.1), (3, 3, 50.17, 0.0), (3, 4, 45.51, 0.0),
    (4, 3, 0.0, -9.351), (4, 4, 55.5, 3.0), (4, 5, -1.28, 0.0),
    (5, 4, -2.0, 0.0), (5, 5, 63.25, 1.08), (5, 6, 1.08, 0.0),
    (6, 5, 0.0, 1.0), (6, 6, 33.0, 0.0), (6, 7, 2.05, 0.0),
    (7, 6, 0.0, -0.3), (7, 7, 44.78, 0.0),
]
for i, j, re, im in entries:
    coo.put(i, j, re + 1j * im)

rng = np.random.default_rng(1)
x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
A = np.asarray(coo.as_dense())
b = A @ x_true

for genie in (Genie.DENSE, Genie.SPLU):
    solver = LinSolver(genie, device=device)
    solver.factorize(coo)
    x = solver.solve(b).cpu().numpy()
    v = VerifyLinSys.from_system(coo, x, b)
    print(f"{genie.value:>6}: rel_err = {v.relative_error:.2e}  "
          f"max|x - x_true| = {np.max(np.abs(x - x_true)):.2e}")
    assert v.relative_error < 1e-10
print("ok")
