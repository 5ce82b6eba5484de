"""Gamma/beta family and error functions with inverse round trips
(mirrors russell_lab examples/math_beta_gamma_functions.rs and
math_erf_erfc_functions.rs).

Usage: python examples_torch/ex_math_beta_gamma_erf.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

from russell_tpu_torch.math import (beta, erf, erf_inv, erfc, erfc_inv, gamma,
                                    ln_beta, ln_gamma)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# gamma oracles: Gamma(n) = (n-1)!, Gamma(1/2) = sqrt(pi)
assert abs(float(gamma(5.0, device)) - 24.0) < 1e-12
assert abs(float(gamma(0.5, device)) - math.sqrt(math.pi)) < 1e-14
assert abs(float(ln_gamma(10.0, device)) - math.lgamma(10.0)) < 1e-12

# beta via gamma identity B(a,b) = G(a)G(b)/G(a+b)
for a, b in ((2.0, 3.0), (0.5, 0.5), (4.5, 1.25)):
    ref = math.gamma(a) * math.gamma(b) / math.gamma(a + b)
    assert abs(float(beta(a, b, device)) - ref) < 1e-12 * ref
    assert abs(float(ln_beta(a, b, device)) - math.log(ref)) < 1e-12

# erf/erfc complementarity and point oracles
for x in (0.0, 0.5, 1.0, 2.0):
    assert abs(float(erf(x, device)) + float(erfc(x, device)) - 1.0) < 1e-14
    assert abs(float(erf(x, device)) - math.erf(x)) < 1e-14

# inverse round trips
for p in (0.1, 0.5, 0.9):
    assert abs(float(erf(erf_inv(p, device))) - p) < 1e-12
    assert abs(float(erfc(erfc_inv(p, device))) - p) < 1e-12
print("Gamma(0.5)^2 =", float(gamma(0.5, device)) ** 2, "(pi)")
print("beta/gamma/erf OK")
