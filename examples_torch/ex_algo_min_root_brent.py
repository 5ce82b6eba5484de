"""Minimum bracketing + Brent minimization + Brent root finding
(mirrors russell_lab examples/algo_min_and_root_solver_brent.rs).

Usage: python examples_torch/ex_algo_min_root_brent.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

from russell_tpu_torch.algo import MinBracketing, MinSolver, RootFinder

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def f(x, args):
    return x * x - 1.0         # minimum at x = 0, roots at +-1


br = MinBracketing().set_enable_stats(True)
bracket = br.basic(-5.0, f)
print(f"bracket: a={bracket.a:.4f} b={bracket.b:.4f} c={bracket.c:.4f}")
assert bracket.a < 0.0 < bracket.c

ms = MinSolver().set_enable_stats(True)
xmin = ms.brent(bracket.a, bracket.c, f)
print(f"brent minimum:  x* = {xmin:.10f}  "
      f"({ms.get_stats().n_function} evaluations)")
assert abs(xmin) < 1e-8

rf = RootFinder().set_enable_stats(True)
root = rf.brent(0.2, 3.0, f)
print(f"brent root:     x0 = {root:.10f}  "
      f"({rf.get_stats().n_function} evaluations)")
assert abs(root - 1.0) < 1e-10

# a transcendental one: sin(x) = x/2 on [1.5, 3]
root2 = rf.brent(1.5, 3.0, lambda x, a: math.sin(x) - 0.5 * x)
print(f"sin(x)=x/2:     x0 = {root2:.10f}")
assert abs(math.sin(root2) - 0.5 * root2) < 1e-12
print("ok")
