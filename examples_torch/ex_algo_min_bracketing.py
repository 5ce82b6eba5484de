"""Minimum bracketing then Brent minimization (mirrors
russell_lab/examples/algo_min_bracketing_and_solver.rs).

Usage: python examples_torch/ex_algo_min_bracketing.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.algo import MinBracketing, MinSolver

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def f(x, _args=None):
    return (x - 1.5) ** 2 + 2.0


br = MinBracketing().set_enable_stats(True)
bracket = br.basic(0.0, f)
a, b, c = bracket.a, bracket.b, bracket.c
assert a < b < c and bracket.fb < bracket.fa and bracket.fb < bracket.fc
solver = MinSolver().set_enable_stats(True)
xmin = solver.brent(a, c, f)
print(f"bracket ({a:.4f}, {b:.4f}, {c:.4f}) -> xmin = {xmin:.10f}")
print("bracketing calls:", br.get_stats().n_function,
      "brent calls:", solver.get_stats().n_function)
assert abs(xmin - 1.5) < 1e-7
print("min bracketing + brent OK")
