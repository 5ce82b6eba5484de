"""Derivative checkers + linear fitting + bracketed minimization
(mirrors russell_lab examples check_1st_and_2nd_derivatives.rs,
algo_linear_fitting.rs, algo_min_bracketing_and_solver.rs).

Usage: python examples_torch/ex_lab_deriv_checks_fitting.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.algo import MinBracketing, MinSolver, linear_fitting
from russell_tpu_torch.core import check

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# 1) validate analytical derivatives against central differences:
#    the reference public mini-framework for checking Jacobians


def f(x):
    return math.sin(2.0 * x) * math.exp(-x)


def df(x):
    return (2.0 * math.cos(2.0 * x) - math.sin(2.0 * x)) * math.exp(-x)


for x in np.linspace(-1.0, 2.0, 7):
    check.deriv1_approx_eq(df(x), x, 1e-8, lambda t: f(t))
print("deriv1 checks pass on 7 stations")

# 2) least-squares line fit (algo_linear_fitting.rs)
x = np.array([0.0, 1.0, 3.0, 5.0])
y = np.array([1.0, 0.0, 2.0, 4.0])
c0, c1 = linear_fitting(x, y)
print(f"fit: y = {c0:.4f} + {c1:.4f} x")
check.approx_eq(c0, 0.1864406779661017, 1e-14)
check.approx_eq(c1, 0.6949152542372882, 1e-14)


# 3) bracket then minimize (Brent): min of x^2 - x at x = 0.5
def g(x, args):
    return x * x - x


br = MinBracketing().basic(0.3, g)
xm = MinSolver().brent(br.a, br.c, g)
print(f"bracket [{br.a:.3f}, {br.c:.3f}] -> min at x = {xm:.12f}")
check.approx_eq(xm, 0.5, 1e-8)
print("ok")
