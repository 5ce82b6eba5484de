"""Adaptive quadrature + linear fitting
(mirrors russell_lab examples/algo_quadrature_integrate_1d.rs,
algo_linear_fitting.rs).

Usage: python examples_torch/ex_algo_quadrature_fitting.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.algo import Quadrature, linear_fitting

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

quad = Quadrature().set_enable_stats(True)
# int_0^1 x e^x dx = 1
v = quad.integrate(0.0, 1.0, lambda x, a: x * math.exp(x))
print(f"int x e^x     = {v:.12f} ({quad.get_stats().n_function} evals)")
assert abs(v - 1.0) < 1e-12
# int_0^pi sin = 2
v2 = quad.integrate(0.0, math.pi, lambda x, a: math.sin(x))
print(f"int sin       = {v2:.12f}")
assert abs(v2 - 2.0) < 1e-12
# mildly singular-ish: int_0^1 sqrt(x) dx = 2/3
v3 = quad.integrate(0.0, 1.0, lambda x, a: math.sqrt(x))
print(f"int sqrt(x)   = {v3:.12f}")
assert abs(v3 - 2.0 / 3.0) < 1e-9

# linear fitting y = a + b x (examples/algo_linear_fitting.rs data)
x = np.array([0.0, 1.0, 3.0, 5.0])
y = np.array([1.0, 0.0, 2.0, 4.0])
a, b = linear_fitting(x, y)
print(f"fit: y = {a:.6f} + {b:.6f} x")
assert abs(a - 0.1864406779661015) < 1e-12
assert abs(b - 0.6949152542372882) < 1e-12
# forced through zero
a0, b0 = linear_fitting(x, y, pass_through_zero=True)
print(f"fit0: y = {b0:.6f} x")
assert abs(a0) < 1e-15
print("ok")
