"""Rectangular matrices: SVD-based pseudo-inverse and least squares
(mirrors russell_lab mat_pseudo_inverse doc surface on the rectangular
sample family of russell_sparse samples.rs: rectangular_3x4 et al.).

Usage: python examples_torch/ex_lab_pseudo_inverse.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.dense import mat_pseudo_inverse, mat_svd

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = torch.tensor([[1.0, 2.0, 0.0, 1.0],
                  [2.0, 0.0, 1.0, -1.0],
                  [0.0, 1.0, 3.0, 2.0]], dtype=torch.float64, device=device)
an = A.cpu().numpy()

# Moore-Penrose conditions
Ai = mat_pseudo_inverse(A).cpu().numpy()
assert np.allclose(an @ Ai @ an, an, atol=1e-12)
assert np.allclose(Ai @ an @ Ai, Ai, atol=1e-12)
assert np.allclose((an @ Ai).T, an @ Ai, atol=1e-12)
assert np.allclose((Ai @ an).T, Ai @ an, atol=1e-12)

# least squares via pinv matches the normal-equations solution for an
# overdetermined system
B = torch.tensor([[1.0, 1.0], [1.0, 2.0], [1.0, 3.0], [1.0, 4.0]],
                 dtype=torch.float64, device=device)
y = np.asarray([6.0, 5.0, 7.0, 10.0])
coef = mat_pseudo_inverse(B).cpu().numpy() @ y
ref = np.linalg.lstsq(B.cpu().numpy(), y, rcond=None)[0]
assert np.allclose(coef, ref, atol=1e-12)
print("least-squares line: intercept=%.4f slope=%.4f" % tuple(coef))

# SVD returns (s, u, vt): singular values match numpy
res = mat_svd(A)
s = res[0].cpu().numpy()
assert np.allclose(np.sort(s)[::-1],
                   np.linalg.svd(an, compute_uv=False), atol=1e-12)
print("pseudo-inverse OK")
