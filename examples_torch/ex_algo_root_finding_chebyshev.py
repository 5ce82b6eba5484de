"""RootFinder: all roots in an interval via adaptive Chebyshev proxy +
companion-matrix eigenvalues + Newton polish (mirrors
russell_lab/examples/algo_root_finding_chebyshev.rs).

Usage: python examples_torch/ex_algo_root_finding_chebyshev.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.algo import InterpChebyshev, RootFinder

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# f has 5 roots in [-4, 4]: sin(2x) * exp(-x^2/10) + 0.1 shifts them
def f(x, args=None):
    return math.sin(2.0 * x) * math.exp(-x * x / 10.0) + 0.1


interp = InterpChebyshev(200, -4.0, 4.0).adapt_function(1e-12, f)
finder = RootFinder()
roots = np.asarray(finder.chebyshev(interp))
print("roots from Chebyshev companion matrix:", np.round(roots, 10))
refined = np.asarray(finder.refine(list(roots), -4.0, 4.0,
                                   lambda x, a: f(x)))
for r in refined:
    assert abs(f(r)) < 1e-12, r
# cross-check every root with Brent on a small bracket
for r in refined:
    rb = finder.brent(r - 0.2, r + 0.2, lambda x, a: f(x))
    assert abs(rb - r) < 1e-9
print(f"{len(refined)} roots, all |f| < 1e-12 and Brent-confirmed")
print("ok")
