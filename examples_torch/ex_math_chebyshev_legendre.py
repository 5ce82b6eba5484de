"""Chebyshev and Legendre polynomial families: point values, derivatives,
Gauss/Lobatto points and quadrature weights (mirrors russell_lab
examples/math_chebyshev_functions.rs, math_chebyshev_points.rs and the
legendre doc surface).

Usage: python examples_torch/ex_math_chebyshev_legendre.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.math import (chebyshev_gauss_points,
                                    chebyshev_lobatto_points, chebyshev_tn,
                                    chebyshev_tn_deriv1, chebyshev_un,
                                    legendre_gauss_points,
                                    legendre_gauss_weights,
                                    legendre_lobatto_points, legendre_pn,
                                    legendre_pn_deriv1)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def tn(n, x):
    return float(chebyshev_tn(n, x, device))


def pn(n, x):
    return float(legendre_pn(n, x, device))


# T_n(cos t) = cos(n t): the defining identity
for n in (0, 1, 3, 7):
    for t in (0.3, 1.1, 2.5):
        assert abs(tn(n, math.cos(t)) - math.cos(n * t)) < 1e-12
# U_n(cos t) sin t = sin((n+1) t)
assert abs(float(chebyshev_un(4, math.cos(0.7), device)) * math.sin(0.7)
           - math.sin(5 * 0.7)) < 1e-12
# T_5' at x via the derivative routine vs finite differences
x = 0.3
h = 1e-6
fd = (tn(5, x + h) - tn(5, x - h)) / (2 * h)
assert abs(float(chebyshev_tn_deriv1(5, x, device)) - fd) < 1e-7
# Chebyshev-Gauss points are cos((2k+1)pi/(2n+2)); Lobatto include +-1
xg = np.asarray(chebyshev_gauss_points(8))
assert np.all(np.abs(np.asarray([tn(9, v) for v in xg])) < 1e-12)
xl = np.asarray(chebyshev_lobatto_points(8))
assert abs(xl[0] + 1.0) < 1e-15 and abs(xl[-1] - 1.0) < 1e-15

# Legendre: P_4 at the standard oracle point
assert abs(pn(4, 0.5) - (-0.2890625)) < 1e-12
fd = (pn(4, x + h) - pn(4, x - h)) / (2 * h)
assert abs(float(legendre_pn_deriv1(4, x, device)) - fd) < 1e-7
# Gauss-Legendre quadrature: legendre_gauss_points(n) returns the n+1
# roots of P_{n+1}; 5 points integrate x^6 over [-1, 1] exactly
xq = np.asarray(legendre_gauss_points(4))
wq = np.asarray(legendre_gauss_weights(4))
assert len(xq) == 5
val = float(np.sum(wq * xq ** 6))
assert abs(val - 2.0 / 7.0) < 1e-13
assert np.all(np.abs(np.asarray([pn(5, v) for v in xq])) < 1e-12)
xlo = np.asarray(legendre_lobatto_points(5))
assert abs(xlo[0] + 1.0) < 1e-15 and abs(xlo[-1] - 1.0) < 1e-15
print("int_{-1}^{1} x^6 dx =", val, "(exact 2/7)")
print("chebyshev/legendre OK")
