"""erf/erfc/erf_inv/erfc_inv round trips (mirrors
russell_lab/examples/math_erf_erfc_functions.rs).

Usage: python examples_torch/ex_math_erf_erfc.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from scipy import special as sp

from russell_tpu_torch.math import erf, erf_inv, erfc, erfc_inv

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

for x in np.linspace(-2.5, 2.5, 11):
    assert abs(float(erf(x, device)) - sp.erf(x)) < 1e-14
    assert abs(float(erfc(x, device)) - sp.erfc(x)) < 1e-14
for p in np.linspace(-0.95, 0.95, 9):
    x = float(erf_inv(p, device))
    assert abs(float(erf(x, device)) - p) < 1e-12
q = float(erfc_inv(0.25, device))
assert abs(float(erfc(q, device)) - 0.25) < 1e-12
print("erf(1) =", float(erf(1.0, device)), "erf_inv(erf(1)) =",
      float(erf_inv(float(erf(1.0, device)), device)))
print("erf family OK")
