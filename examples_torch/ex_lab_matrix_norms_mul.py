"""Matrix norms, matrix multiplication and matrix-vector products
(mirrors russell_lab examples/matrix_norms.rs, matrix_multiplication.rs,
matrix_vector_multiplication.rs, matvec_solve_linear_system.rs).

Usage: python examples_torch/ex_lab_matrix_norms_mul.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.core import Norm
from russell_tpu_torch.dense import (mat_mat_mul, mat_norm, mat_t_mat_mul,
                                     mat_vec_mul, solve_lin_sys)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = torch.tensor([[2.0, 1.0, 0.0],
                  [1.0, 3.0, 1.0],
                  [0.0, 1.0, 4.0]], dtype=torch.float64, device=device)

# norms (matrix_norms.rs): One = max col sum, Inf = max row sum,
# Fro = Frobenius, Max = max |a_ij|
an = A.cpu().numpy()
assert float(mat_norm(A, Norm.ONE)) == np.abs(an).sum(axis=0).max()
assert float(mat_norm(A, Norm.INF)) == np.abs(an).sum(axis=1).max()
assert abs(float(mat_norm(A, Norm.FRO)) - np.linalg.norm(an, "fro")) < 1e-14
assert float(mat_norm(A, Norm.MAX)) == 4.0

# C = alpha A B and C = alpha A^T B (matrix_multiplication.rs)
B = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], dtype=torch.float64,
                 device=device)
C = mat_mat_mul(2.0, A, B)
assert np.allclose(C.cpu().numpy(), 2.0 * an @ B.cpu().numpy())
Ct = mat_t_mat_mul(1.0, A, A)
assert np.allclose(Ct.cpu().numpy(), an.T @ an)

# v = alpha A u (matrix_vector_multiplication.rs)
u = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device=device)
v = mat_vec_mul(1.0, A, u)
assert np.allclose(v.cpu().numpy(), an @ u.cpu().numpy())

# dense linear solve (matvec_solve_linear_system.rs)
b = torch.tensor([4.0, 9.0, 14.0], dtype=torch.float64, device=device)
x = solve_lin_sys(A, b)
assert np.allclose((A @ x).cpu().numpy(), b.cpu().numpy(), atol=1e-12)
print("x =", x.cpu().numpy())
print("matrix norms/mul OK")
