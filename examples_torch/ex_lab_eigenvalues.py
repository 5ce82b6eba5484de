"""Eigenvalues: general (dgeev analog), symmetric, and generalized
(mirrors russell_lab examples/matrix_eigenvalues.rs,
matrix_eigenvalues_symmetric.rs). The symmetric Jacobi twin runs the
``jacobi_eig`` kernel on the card.

Usage: python examples_torch/ex_lab_eigenvalues.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.dense import (mat_eigen, mat_eigen_sym,
                                     mat_eigen_sym_jacobi, mat_gen_eigen)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# general (nonsymmetric): rotation-like matrix with a complex pair
a = np.array([[0.0, 1.0, 0.0],
              [0.0, 0.0, 1.0],
              [1.0, 0.0, 0.0]])
lr, li, vr, vi = (m.cpu().numpy() for m in mat_eigen(a, device=device))
lam = np.sort_complex(lr + 1j * li)
print("eigenvalues:", np.round(lam, 12))
# cube roots of unity
expect = np.sort_complex(np.exp(2j * np.pi * np.arange(3) / 3))
assert np.allclose(lam, expect, atol=1e-12)

# symmetric: eigh vs the dual-implementation Jacobi rotation check
s = np.array([[2.0, 0.0, 0.0], [0.0, 3.0, 4.0], [0.0, 4.0, 9.0]])
w, v = (m.cpu().numpy() for m in mat_eigen_sym(s, device=device))
wj, vj = (m.cpu().numpy() for m in mat_eigen_sym_jacobi(s, device=device))
print("sym eigenvalues:", np.sort(w))
assert np.allclose(np.sort(w), [1.0, 2.0, 11.0], atol=1e-12)
assert np.allclose(np.sort(w), np.sort(wj), atol=1e-10)

# generalized A v = lambda B v
A = np.diag([2.0, 6.0, 12.0])
B = np.diag([1.0, 2.0, 3.0])
glr, gli, _, _ = (m.cpu().numpy() for m in mat_gen_eigen(A, B, device=device))
print("generalized:", np.sort(glr))
assert np.allclose(np.sort(glr), [2.0, 3.0, 4.0], atol=1e-12)
print("ok")
