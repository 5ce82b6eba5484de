"""Cholesky, SVD, inverse and pseudo-inverse
(mirrors russell_lab examples/matrix_cholesky_3x3.rs,
matrix_singular_value_decomposition.rs).

Usage: python examples_torch/ex_lab_cholesky_svd_inverse.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.dense import (mat_cholesky, mat_inverse,
                                     mat_pseudo_inverse, mat_svd)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# Cholesky of the reference 3x3 SPD sample
a = np.array([[4.0, 12.0, -16.0],
              [12.0, 37.0, -43.0],
              [-16.0, -43.0, 98.0]])
L = mat_cholesky(a, device=device).cpu().numpy()
print("L =\n", np.round(L, 12))
assert np.allclose(L @ L.T, a, atol=1e-12)
assert np.allclose(L, np.tril(L))

# SVD of a rectangular matrix
b = np.array([[1.0, 0.0, 0.0, 1.0, 2.0],
              [0.0, 0.0, 3.0, 0.0, 0.0],
              [0.0, 0.0, 0.0, 0.0, 0.0],
              [0.0, 2.0, 0.0, 0.0, 0.0]])
s, u, vt = (m.cpu().numpy() for m in mat_svd(b, device=device))
print("sigma =", np.round(s, 12))
S = np.zeros_like(b)
S[:len(s), :len(s)] = np.diag(s)
assert np.allclose(u @ S @ vt, b, atol=1e-12)

# inverse + pseudo-inverse
c = np.array([[1.0, 2.0], [3.0, 4.0]])
ci, det = mat_inverse(c, device=device)
ci = ci.cpu().numpy()
assert abs(float(det) - (-2.0)) < 1e-14
assert np.allclose(ci @ c, np.eye(2), atol=1e-12)
bp = mat_pseudo_inverse(b, device=device).cpu().numpy()
assert np.allclose(b @ bp @ b, b, atol=1e-11)
print("inverse and pseudo-inverse verified")
print("ok")
