"""Superquadric surface coordinates via the signed-power sin/cos
(mirrors russell_lab/examples/math_plot_superquadric_functions.rs:
x = A suq_cos(theta,k)suq_cos(phi,k) ... tabulated on a small grid).

Usage: python examples_torch/ex_math_superquadric.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.math.basic import suq_cos, suq_sin

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

A = B = C = 1.0
for k in (0.5, 1.0, 2.0, 3.0):
    pts = []
    for th in np.linspace(-np.pi / 2, np.pi / 2, 7):
        for ph in np.linspace(-np.pi, np.pi, 9):
            cth = float(suq_cos(th, k, device))
            x = A * cth * float(suq_cos(ph, k, device))
            y = B * cth * float(suq_sin(ph, k, device))
            z = C * float(suq_sin(th, k, device))
            pts.append((x, y, z))
            # superquadric implicit equation |x|^(2/k)+|y|^(2/k)+|z|^(2/k)=1
            lhs = (abs(x) ** (2.0 / k) + abs(y) ** (2.0 / k)
                   + abs(z) ** (2.0 / k))
            assert abs(lhs - 1.0) < 1e-9
    print(f"k={k}: {len(pts)} surface points, eq residual < 1e-9")
print("superquadric OK")
