"""First-kind/second-kind Bessel function table (mirrors
russell_lab/examples/math_bessel_functions.rs: J0/J1/J2 and Y0/Y1/Y2
tabulated over x, checked against SciPy independent implementation).

Usage: python examples_torch/ex_math_bessel.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from scipy import special as sp

from russell_tpu_torch.math import (bessel_j0, bessel_j1, bessel_jn,
                                    bessel_y0, bessel_y1, bessel_yn)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

xs = np.linspace(0.1, 15.0, 12)
print(f"{'x':>6} {'J0':>12} {'J1':>12} {'J2':>12} {'Y0':>12}")
for x in xs:
    j0, j1, j2 = (float(bessel_j0(x, device)), float(bessel_j1(x, device)),
                  float(bessel_jn(2, x, device)))
    y0, y1, y2 = (float(bessel_y0(x, device)), float(bessel_y1(x, device)),
                  float(bessel_yn(2, x, device)))
    print(f"{x:6.2f} {j0:12.6f} {j1:12.6f} {j2:12.6f} {y0:12.6f}")
    assert abs(j0 - sp.j0(x)) < 1e-13
    assert abs(j1 - sp.j1(x)) < 1e-13
    assert abs(j2 - sp.jn(2, x)) < 1e-13
    assert abs(y0 - sp.y0(x)) < 1e-12
    assert abs(y1 - sp.y1(x)) < 1e-12
    assert abs(y2 - sp.yn(2, x)) < 1e-12
print("bessel J/Y OK")
