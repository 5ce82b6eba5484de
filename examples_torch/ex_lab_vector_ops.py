"""Vector operations tour: axpy/update, dot/inner, norms, scale/copy and
the outer product (mirrors russell_lab examples/vector_axpy_and_sum.rs,
vector_dot_scale_and_copy.rs, vector_norms.rs, vector_outer_product.rs).

Usage: python examples_torch/ex_lab_vector_ops.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.core import Norm
from russell_tpu_torch.dense import (vec_add, vec_copy, vec_inner, vec_norm,
                                     vec_outer, vec_scale, vec_update)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def vec(*xs):
    return torch.tensor(xs, dtype=torch.float64, device=device)


u = vec(1.0, 2.0, 3.0, 4.0)
v = vec(4.0, 3.0, 2.0, 1.0)

# w = alpha*u + beta*v (vector_axpy_and_sum.rs role)
w = vec_add(0.5, u, 2.0, v)
assert np.allclose(w.cpu().numpy(), [8.5, 7.0, 5.5, 4.0])
# update: v += alpha*u
v2 = vec_update(2.0, u, v)
assert np.allclose(v2.cpu().numpy(), [6.0, 7.0, 8.0, 9.0])

# dot, scale, copy (vector_dot_scale_and_copy.rs)
d = float(vec_inner(u, v))
assert d == 4.0 + 6.0 + 6.0 + 4.0
s = vec_scale(0.25, u)
c = vec_copy(s)
assert np.allclose(c.cpu().numpy(), [0.25, 0.5, 0.75, 1.0])

# norms (vector_norms.rs): One = sum|.|, Euc = l2, Max = linf
x = vec(-3.0, 4.0, 0.0)
assert float(vec_norm(x, Norm.ONE)) == 7.0
assert abs(float(vec_norm(x, Norm.EUC)) - 5.0) < 1e-15
assert float(vec_norm(x, Norm.MAX)) == 4.0

# outer product (vector_outer_product.rs): A = u v^T
A = vec_outer(1.0, u, v).cpu().numpy()
assert A.shape == (4, 4)
assert np.allclose(A, np.outer(u.cpu().numpy(), v.cpu().numpy()))
print("u . v =", d)
print("outer(u, v) row 0 =", A[0])
print("vector ops OK")
