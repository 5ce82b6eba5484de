"""Elliptic integrals F(phi,m), E(phi,m), Pi(n,phi,m) via Carlson forms
(mirrors russell_lab/examples/math_elliptic_functions.rs).

Usage: python examples_torch/ex_math_elliptic.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from scipy import special as sp

from russell_tpu_torch.math import elliptic_e, elliptic_f, elliptic_pi

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

for phi in np.linspace(0.1, 1.4, 6):
    for m in (0.1, 0.5, 0.9):
        f = float(elliptic_f(phi, m, device))
        e = float(elliptic_e(phi, m, device))
        assert abs(f - sp.ellipkinc(phi, m)) < 1e-12
        assert abs(e - sp.ellipeinc(phi, m)) < 1e-12
        print(f"phi={phi:4.2f} m={m:3.1f} F={f:10.6f} E={e:10.6f}")
p = float(elliptic_pi(0.3, 0.8, 0.5, device))
print("Pi(0.3, 0.8, 0.5) =", p)
print("elliptic OK")
