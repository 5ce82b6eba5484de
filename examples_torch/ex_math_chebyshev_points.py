"""Chebyshev-Gauss and Chebyshev-Gauss-Lobatto point families (mirrors
russell_lab/examples/math_chebyshev_points.rs).

Usage: python examples_torch/ex_math_chebyshev_points.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.math import (chebyshev_gauss_points,
                                    chebyshev_lobatto_points, chebyshev_tn)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

n = 8
g = np.asarray(chebyshev_gauss_points(n))
l = np.asarray(chebyshev_lobatto_points(n))
print("gauss  :", np.array2string(g, precision=4))
print("lobatto:", np.array2string(l, precision=4))
# Gauss points are the roots of T_{n+1}; Lobatto points the extrema
for x in g:
    assert abs(float(chebyshev_tn(n + 1, x, device))) < 1e-13
assert abs(l[0] + 1.0) < 1e-15 and abs(l[-1] - 1.0) < 1e-15
for x in l[1:-1]:
    t = float(chebyshev_tn(n, x, device))
    assert abs(t) in (0.0,) or abs(abs(t) - 1.0) < 1e-12
print("chebyshev points OK")
