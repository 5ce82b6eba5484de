"""Lorene 1-D PDE by spectral collocation + error sweep
(mirrors russell_lab examples/algo_lorene_1d_pde_spectral_collocation.rs
and algo_lorene_1d_pde_spectral_errors.rs; Gourgoulhon 2005, page 25):

    u'' - 4 u' + 4 u = e^x + C,   C = -4e / (1 + e^2),   u(-1) = u(1) = 0

Exact solution: u(x) = e^x - (sinh(1)/sinh(2)) e^{2x} + C/4.
The collocation system (D2 - 4 D1 + 4 I) u = b is assembled from
InterpLagrange differentiation matrices on Chebyshev-Gauss-Lobatto
points and solved densely on the device; boundary rows are replaced by
the Dirichlet conditions.

Usage: python examples_torch/ex_pde_lorene_1d_spectral.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.algo import InterpLagrange
from russell_tpu_torch.dense import solve_lin_sys

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

C = -4.0 * math.e / (1.0 + math.e * math.e)


def exact(x):
    return np.exp(x) - math.sinh(1.0) / math.sinh(2.0) * np.exp(2.0 * x) \
        + C / 4.0


def solve(nn: int) -> float:
    interp = InterpLagrange(nn)
    interp.calc_dd1_matrix()
    interp.calc_dd2_matrix()
    dd1 = np.asarray(interp.get_dd1())
    dd2 = np.asarray(interp.get_dd2())
    xx = np.asarray(interp.get_points())
    npoint = xx.shape[0]
    aa = dd2 - 4.0 * dd1 + 4.0 * np.eye(npoint)
    b = np.exp(xx) + C
    # Dirichlet boundary conditions u(-1) = u(1) = 0
    for k in (0, npoint - 1):
        aa[k, :] = 0.0
        aa[k, k] = 1.0
        b[k] = 0.0
    uu = solve_lin_sys(aa, b, device=device).cpu().numpy()
    return float(np.max(np.abs(uu - exact(xx))))


# the reference example resolution
err16 = solve(16)
print(f"N = 16: max(|u - exact|) = {err16:.3e}")
assert err16 < 1e-6

# error sweep (algo_lorene_1d_pde_spectral_errors.rs): spectral decay
print(f"{'N':>4} {'max_error':>12}")
prev = None
for nn in (4, 6, 8, 12, 16, 24):
    err = solve(nn)
    print(f"{nn:>4} {err:>12.3e}")
    if prev is not None and nn <= 16:
        assert err < prev, "spectral convergence should be monotone here"
    prev = err
assert solve(24) < 1e-12
print("ok")
