"""Cholesky factorization of small SPD matrices (mirrors
russell_lab/examples/matrix_cholesky_3x3.rs and matrix_cholesky_4x4.rs).

Usage: python examples_torch/ex_lab_cholesky_small.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.dense import mat_cholesky

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A3 = torch.tensor([[4.0, 12.0, -16.0],
                   [12.0, 37.0, -43.0],
                   [-16.0, -43.0, 98.0]], dtype=torch.float64, device=device)
L3 = mat_cholesky(A3).cpu().numpy()
assert np.allclose(L3 @ L3.T, A3.cpu().numpy())
print("L(3x3) =\n", np.array2string(L3, precision=4))

A4 = torch.tensor([[2.0, 1.0, 1.0, 1.0],
                   [1.0, 3.0, 1.0, 1.0],
                   [1.0, 1.0, 4.0, 1.0],
                   [1.0, 1.0, 1.0, 5.0]], dtype=torch.float64, device=device)
L4 = mat_cholesky(A4).cpu().numpy()
assert np.allclose(L4 @ L4.T, A4.cpu().numpy())
# solve A x = b through the factor
b = np.asarray([1.0, 2.0, 3.0, 4.0])
y = np.linalg.solve(L4, b)
x = np.linalg.solve(L4.T, y)
assert np.allclose(A4.cpu().numpy() @ x, b)
print("x =", np.array2string(x, precision=6))
print("cholesky OK")
