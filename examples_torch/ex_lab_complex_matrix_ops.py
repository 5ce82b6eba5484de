"""Complex matrix operations: zip/unzip between real-pair and complex
storage, complex matmul and norms (mirrors russell_lab
examples/complex_matrix_multiplication.rs, complex_matrix_norms.rs).

Usage: python examples_torch/ex_lab_complex_matrix_ops.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.core import Norm
from russell_tpu_torch.dense import (complex_mat_unzip, complex_mat_zip,
                                     mat_mat_mul, mat_norm, mat_vec_mul)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = torch.tensor([[1 + 1j, 2.0, 0 + 1j],
                  [3 - 1j, 1 - 1j, 1.0],
                  [0.0, 2 + 2j, -1 + 0.5j]], dtype=torch.complex128,
                 device=device)
an = A.cpu().numpy()

# zip/unzip round trip: (real, imag) planes <-> complex storage
re, im = complex_mat_unzip(A)
A2 = complex_mat_zip(re, im)
assert np.allclose(A2.cpu().numpy(), an)

# complex matrix multiplication against numpy
B = torch.tensor([[1.0, 0 + 1j], [2 - 1j, 1.0], [0.0, 3 + 0j]],
                 dtype=torch.complex128, device=device)
C = mat_mat_mul(1.0 + 0j, A, B).cpu().numpy()
assert np.allclose(C, an @ B.cpu().numpy())

# complex matrix-vector product
u = torch.tensor([1 + 0j, 2 - 1j, 0 + 1j], dtype=torch.complex128,
                 device=device)
v = mat_vec_mul(1.0 + 0j, A, u)
assert np.allclose(v.cpu().numpy(), an @ u.cpu().numpy())

# norms of a complex matrix
assert abs(float(mat_norm(A, Norm.ONE))
           - np.abs(an).sum(axis=0).max()) < 1e-14
assert abs(float(mat_norm(A, Norm.INF))
           - np.abs(an).sum(axis=1).max()) < 1e-14
assert abs(float(mat_norm(A, Norm.FRO))
           - np.linalg.norm(an, "fro")) < 1e-14
print("C[0] =", C[0])
print("complex matrix ops OK")
