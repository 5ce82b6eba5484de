"""Symmetric eigenproblems: mat_eigen_sym (LAPACK role) vs the native
Jacobi-rotation twin, whose sweeps the ``jacobi_eig`` kernel runs on the
card (mirrors russell_lab/examples/matrix_eigenvalues_symmetric.rs and
matrix_eigenvalues_symmetric_3x3.rs; the dual-implementation cross-check
is the reference own test idea).

Usage: python examples_torch/ex_lab_eigen_symmetric.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.dense import mat_eigen_sym, mat_eigen_sym_jacobi

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = torch.tensor([[2.0, 0.0, 0.0],
                  [0.0, 3.0, 4.0],
                  [0.0, 4.0, 9.0]], dtype=torch.float64, device=device)
l, v = (m.cpu().numpy() for m in mat_eigen_sym(A))
lj, vj = (m.cpu().numpy() for m in mat_eigen_sym_jacobi(A))
print("eigenvalues (lapack-role):", l)
print("eigenvalues (jacobi):", np.sort(lj))
assert np.allclose(np.sort(l), [1.0, 2.0, 11.0])
assert np.allclose(np.sort(lj), np.sort(l), atol=1e-12)

# residual A v = lambda v
An = A.cpu().numpy()
for k in range(3):
    r = An @ v[:, k] - float(l[k]) * v[:, k]
    assert np.max(np.abs(r)) < 1e-12

# 5x5 case
rng = np.random.default_rng(3)
M = rng.normal(size=(5, 5))
M = (M + M.T) / 2
l5, v5 = mat_eigen_sym(M, device=device)
assert np.allclose(np.sort(l5.cpu().numpy()), np.sort(np.linalg.eigvalsh(M)))
print("symmetric eigen OK")
