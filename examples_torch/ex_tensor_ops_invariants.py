"""Second-order tensor allocation, operations and stress invariants
(mirrors russell_tensor examples/allocating_second_order_tensors.rs and
the operations_t2.rs doc surface: dot/ddot/dyad + sigma_m/sigma_d/Lode).

Usage: python examples_torch/ex_tensor_ops_invariants.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.tensor import (Mandel, Tensor2, t2_ddot_t2, t2_dot_t2,
                                      t2_dyad_t2, t4_ddot_t2)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# symmetric tensor from its 3x3 matrix (allocating_second_order_tensors.rs)
sig = Tensor2.from_matrix([[1.0, 2.0, 0.0],
                           [2.0, -2.0, 0.0],
                           [0.0, 0.0, 3.0]], Mandel.SYMMETRIC, device=device)
m = sig.as_matrix().cpu().numpy()
assert np.allclose(m, [[1, 2, 0], [2, -2, 0], [0, 0, 3]])

# trace / determinant against numpy
assert abs(float(sig.trace()) - 2.0) < 1e-14
assert abs(float(sig.determinant()) - np.linalg.det(m)) < 1e-12

# mean/deviatoric stress invariants: sigma_m = I1/3,
# sigma_d = sqrt(3 J2) (von Mises)
i1 = float(sig.invariant_ii1())
j2 = float(sig.invariant_jj2())
sigma_m = float(sig.invariant_sigma_m())
sigma_d = float(sig.invariant_sigma_d())
assert abs(i1 - 2.0) < 1e-14
assert abs(sigma_m - i1 / 3.0) < 1e-14
assert abs(sigma_d - np.sqrt(3.0 * j2)) < 1e-12
lode = float(sig.invariant_lode())
assert -1.0 - 1e-12 <= lode <= 1.0 + 1e-12

# single and double contraction vs numpy
b = Tensor2.from_matrix([[2.0, 0.0, 1.0],
                         [0.0, 1.0, 0.0],
                         [1.0, 0.0, 2.0]], Mandel.SYMMETRIC, device=device)
bm = b.as_matrix().cpu().numpy()
ab = t2_dot_t2(sig, b)
assert np.allclose(ab.as_matrix().cpu().numpy(), m @ bm)
s = float(t2_ddot_t2(sig, b))
assert abs(s - np.sum(m * bm)) < 1e-12

# dyadic product -> fourth-order tensor in Mandel basis
D = t2_dyad_t2(1.0, sig, b)
# D : b == (b : b) sig
lhs = t4_ddot_t2(1.0, D, b).as_matrix().cpu().numpy()
bb = float(t2_ddot_t2(b, b))
assert np.allclose(lhs, bb * m, atol=1e-12)
print("sigma_m =", sigma_m, " sigma_d =", sigma_d, " lode =", lode)
print("tensor ops/invariants OK")
