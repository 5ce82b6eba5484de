"""Lagrange interpolation on Chebyshev-Gauss-Lobatto points: spectral
convergence of values and derivatives (mirrors russell_lab
examples/algo_interp_lagrange.rs).

Usage: python examples_torch/ex_algo_interp_lagrange.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch

from russell_tpu_torch.algo import InterpLagrange

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def f(x):
    return math.cos(math.exp(2.0 * x))


def g(x):  # df/dx
    return -2.0 * math.exp(2.0 * x) * math.sin(math.exp(2.0 * x))


prev = None
for nn in (4, 8, 16, 32, 64):
    interp = InterpLagrange(nn)
    xx = interp.get_points()
    uu = torch.as_tensor([f(x) for x in xx], dtype=torch.float64,
                         device=device)
    err = max(abs(float(interp.eval(x, uu)) - f(x))
              for x in np.linspace(-1.0, 1.0, 101))
    print(f"N = {nn:3d}  max|p - f| = {err:.2e}  "
          f"Lebesgue ~ {interp.estimate_lebesgue_constant():.3f}")
    prev = err
assert prev < 1e-12            # spectral accuracy at N=64

interp = InterpLagrange(64)
xx = interp.get_points()
uu = torch.as_tensor([f(x) for x in xx], dtype=torch.float64,
                     device=device)
derr = max(abs(float(interp.eval_deriv1(x, uu)) - g(x))
           for x in np.linspace(-1.0, 1.0, 21))
print(f"max|p' - f'| = {derr:.2e}")
assert derr < 1e-8
print("ok")
