"""Analytic tensor derivatives checked against central differences:
invariant gradients (dI1/ds, dJ2/ds, dJ3/ds) and the derivative of the
inverse tensor (mirrors russell_tensor derivatives_t2.rs surface;
the checks follow russell_lab deriv1_approx_eq discipline).

Usage: python examples_torch/ex_tensor_derivatives.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.tensor import (Mandel, Tensor2, deriv1_invariant_ii1,
                                      deriv1_invariant_jj2,
                                      deriv1_invariant_jj3,
                                      deriv_inverse_tensor, t4_ddot_t2)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

rng = np.random.default_rng(7)
a = rng.normal(size=(3, 3))
m = 0.5 * (a + a.T) + 3.0 * np.eye(3)   # symmetric, well-conditioned
sig = Tensor2.from_matrix(m.tolist(), Mandel.SYMMETRIC, device=device)


def num_grad(f, m, h=1e-6):
    """d f / d m_ij by central differences on the 3x3 matrix (symmetric
    perturbation: m_ij and m_ji together, half weight off-diagonal)."""
    g = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            dp = np.zeros((3, 3))
            dp[i, j] += h
            dp[j, i] += h
            gp = float(f(m + 0.5 * dp))
            gm = float(f(m - 0.5 * dp))
            # dp has dp_ij = dp_ji = h (and dp_ii = 2h on the diagonal),
            # so (f(m+dp/2)-f(m-dp/2))/(2h) = G_ij for symmetric G
            g[i, j] = (gp - gm) / (2 * h)
    return g


def t2(mat):
    return Tensor2.from_matrix(mat.tolist(), Mandel.SYMMETRIC, device=device)


def matrix(t):
    return t.as_matrix().cpu().numpy()


# dI1/ds = identity
g1 = matrix(deriv1_invariant_ii1(sig))
n1 = num_grad(lambda mm: t2(mm).invariant_ii1(), m)
assert np.allclose(g1, n1, atol=1e-6), (g1, n1)
# dJ2/ds = deviator(s)
g2 = matrix(deriv1_invariant_jj2(sig))
n2 = num_grad(lambda mm: t2(mm).invariant_jj2(), m)
assert np.allclose(g2, n2, atol=1e-5), (g2, n2)
# dJ3/ds
g3 = matrix(deriv1_invariant_jj3(sig))
n3 = num_grad(lambda mm: t2(mm).invariant_jj3(), m)
assert np.allclose(g3, n3, atol=1e-4), (g3, n3)

# d(A^-1)/dA contracted with a direction dA equals the directional
# derivative -A^-1 dA A^-1
D = deriv_inverse_tensor(sig)
da = rng.normal(size=(3, 3))
da = 0.5 * (da + da.T)
dd = matrix(t4_ddot_t2(1.0, D, t2(da)))
mi = np.linalg.inv(m)
ref = -mi @ da @ mi
assert np.allclose(dd, ref, atol=1e-10), (dd, ref)
print("max |dJ3 analytic - numeric| =", np.max(np.abs(g3 - n3)))
print("tensor derivatives OK")
