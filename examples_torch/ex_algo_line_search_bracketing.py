"""Backtracking line search (Armijo) and downhill minimum bracketing +
Brent refinement (mirrors russell_lab examples/algo_line_search.rs and
algo_min_bracketing_and_solver.rs).

Usage: python examples_torch/ex_algo_line_search_bracketing.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

from russell_tpu_torch.algo import MinBracketing, MinSolver, line_search

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# 1) Armijo line search on f(x) = x^2 - 1 from x = -2 along p = +4


def f(x, _):
    return x * x - 1.0


x0, p = -2.0, 4.0
fx = f(x0, None)
slope = 2.0 * x0 * p   # d f(x0 + t p) / dt at t=0
t = line_search(x0, p, fx, slope, f)
x_new = x0 + t * p
print(f"line search: t = {t:.4f}, x = {x_new:.4f}, "
      f"f = {f(x_new, None):.4f}")
assert f(x_new, None) < fx           # sufficient decrease achieved
assert abs(x_new) < abs(x0)          # moved toward the minimum at 0


# 2) bracket then refine the minimum of f(x) = cos(x) near x = 1
def g(x, _):
    return math.cos(x)


bracketing = MinBracketing()
br = bracketing.basic(1.0, g)
print(f"bracket: a = {br.a:.4f} < b = {br.b:.4f} < c = {br.c:.4f}")
assert br.fb < br.fa and br.fb < br.fc
solver = MinSolver()
xmin = solver.brent(br.a, br.c, g)
print(f"Brent minimum: x = {xmin:.10f} (pi = {math.pi:.10f})")
assert abs(xmin - math.pi) < 1e-8
print("ok")
