"""Modified Bessel functions I0/I1/In and K0/K1/Kn (mirrors
russell_lab/examples/math_bessel_mod_functions.rs).

Usage: python examples_torch/ex_math_bessel_mod.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from scipy import special as sp

from russell_tpu_torch.math import (bessel_i0, bessel_i1, bessel_in,
                                    bessel_k0, bessel_k1, bessel_kn)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

for x in np.linspace(0.05, 8.0, 10):
    i0, i1, i3 = (float(bessel_i0(x, device)), float(bessel_i1(x, device)),
                  float(bessel_in(3, x, device)))
    k0, k1, k3 = (float(bessel_k0(x, device)), float(bessel_k1(x, device)),
                  float(bessel_kn(3, x, device)))
    assert abs(i0 - sp.i0(x)) < 1e-12 * max(1.0, sp.i0(x))
    assert abs(i1 - sp.i1(x)) < 1e-12 * max(1.0, sp.i1(x))
    assert abs(i3 - sp.iv(3, x)) < 1e-11 * max(1.0, abs(sp.iv(3, x)))
    assert abs(k0 - sp.k0(x)) < 1e-12 * max(1.0, sp.k0(x))
    assert abs(k1 - sp.k1(x)) < 1e-12 * max(1.0, sp.k1(x))
    assert abs(k3 - sp.kn(3, x)) < 1e-11 * max(1.0, sp.kn(3, x))
    print(f"x={x:5.2f} I0={i0:12.6g} K0={k0:12.6g}")
print("modified bessel OK")
