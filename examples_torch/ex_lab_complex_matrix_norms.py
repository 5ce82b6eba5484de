"""Complex matrix norms and multiplication (mirrors
russell_lab/examples/complex_matrix_norms.rs and
complex_matrix_multiplication.rs).

Usage: python examples_torch/ex_lab_complex_matrix_norms.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.core import Norm
from russell_tpu_torch.dense import mat_mat_mul, mat_norm

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = torch.tensor([[1 + 1j, 2 - 1j, 0.5j],
                  [3 + 0j, -1 + 2j, 1 - 1j]], dtype=torch.complex128,
                 device=device)
An = A.cpu().numpy()
assert abs(float(mat_norm(A, Norm.ONE)) - np.linalg.norm(An, 1)) < 1e-14
assert abs(float(mat_norm(A, Norm.INF)) - np.linalg.norm(An, np.inf)) < 1e-14
assert abs(float(mat_norm(A, Norm.FRO)) - np.linalg.norm(An, "fro")) < 1e-14
assert abs(float(mat_norm(A, Norm.MAX)) - np.max(np.abs(An))) < 1e-14

B = torch.tensor([[1 - 1j, 0j], [2j, 1 + 0j], [1 + 1j, -1j]],
                 dtype=torch.complex128, device=device)
C = mat_mat_mul(0.5 - 2.0j, A, B).cpu().numpy()
assert np.allclose(C, (0.5 - 2.0j) * (An @ B.cpu().numpy()))
print("one-norm:", float(mat_norm(A, Norm.ONE)),
      "fro:", float(mat_norm(A, Norm.FRO)))
print("alpha*A*B =\n", np.round(C, 4))
print("complex matrix norms/mul OK")
