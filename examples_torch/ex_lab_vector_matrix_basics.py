"""Vector/matrix basics: norms, axpy, inner/outer, matvec, dense solve
(mirrors russell_lab examples/vector_*.rs, matrix_vector_multiplication.rs,
matvec_solve_linear_system.rs).

Usage: python examples_torch/ex_lab_vector_matrix_basics.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.core import Norm
from russell_tpu_torch.dense import (mat_vec_mul, solve_lin_sys, vec_add,
                                     vec_inner, vec_norm, vec_outer)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

u = np.array([1.0, 2.0, 3.0])
v = np.array([4.0, 5.0, 6.0])
w = vec_add(1.0, u, 2.0, v, device=device).cpu().numpy()   # u + 2 v
print("u + 2v      =", w)
assert np.allclose(w, [9.0, 12.0, 15.0])
print("inner(u,v)  =", float(vec_inner(u, v, device=device)))
assert abs(float(vec_inner(u, v, device=device)) - 32.0) < 1e-15
print("|u|_2       =", float(vec_norm(u, Norm.EUC, device=device)))
assert abs(float(vec_norm(u, Norm.EUC, device=device))
           - np.sqrt(14.0)) < 1e-14
outer = vec_outer(1.0, u, v, device=device).cpu().numpy()
print("outer[0]    =", outer[0])
assert np.allclose(outer, np.outer(u, v))

a = np.array([[1.0, 2.0, 3.0], [0.0, 1.0, 4.0], [5.0, 6.0, 0.0]])
au = mat_vec_mul(1.0, a, u, device=device).cpu().numpy()
print("A u         =", au)
assert np.allclose(au, a @ u)
b = np.array([14.0, 14.0, 17.0])
x = solve_lin_sys(a, b, device=device).cpu().numpy()
print("solve(A,b)  =", np.round(x, 12))
assert np.allclose(a @ x, b, atol=1e-12)
print("ok")
