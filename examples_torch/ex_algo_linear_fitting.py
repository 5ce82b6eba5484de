"""Least-squares line fitting, with and without the through-zero
constraint (mirrors russell_lab examples/algo_linear_fitting.rs).

Usage: python examples_torch/ex_algo_linear_fitting.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.algo import linear_fitting

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

x = np.array([0.0, 1.0, 3.0, 5.0])
y = np.array([1.0, 0.0, 2.0, 4.0])
c, m = linear_fitting(x, y)
print(f"free fit:        y = {c:.4f} + {m:.4f} x")
assert abs(c - 0.1864406779661017) < 1e-14
assert abs(m - 0.6949152542372882) < 1e-14

c0, m0 = linear_fitting(x, y, pass_through_zero=True)
print(f"through zero:    y = {c0:.4f} + {m0:.4f} x")
assert c0 == 0.0
assert abs(m0 - float(np.sum(x * y) / np.sum(x * x))) < 1e-15

# the free fit must have the smaller residual
r_free = float(np.sum((y - c - m * x) ** 2))
r_zero = float(np.sum((y - m0 * x) ** 2))
print(f"residuals: free = {r_free:.4f}, through-zero = {r_zero:.4f}")
assert r_free <= r_zero
print("ok")
