"""Composition-function tables: ramp, heaviside, boxcar, logistic and
their derivatives (mirrors russell_lab/examples/math_plot_functions.rs,
tabulated rather than plotted).

Usage: python examples_torch/ex_math_composition_functions.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.math.basic import (boxcar, heaviside, logistic,
                                          logistic_deriv1, ramp, sign,
                                          suq_cos, suq_sin)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

xs = np.linspace(-2.0, 2.0, 9)
print(f"{'x':>6} {'ramp':>8} {'heaviside':>10} {'boxcar':>8} {'logistic':>10}")
for x in xs:
    r = float(ramp(x, device))
    h = float(heaviside(x, device))
    b = float(boxcar(x, -1.0, 1.0, device))
    lg = float(logistic(x, device))
    print(f"{x:6.2f} {r:8.3f} {h:10.3f} {b:8.3f} {lg:10.5f}")
    assert r == max(x, 0.0)
    assert abs(lg - 1.0 / (1.0 + np.exp(-x))) < 1e-15
assert float(sign(-3.0, device)) == -1.0 and float(sign(2.0, device)) == 1.0
assert abs(float(logistic_deriv1(0.0, device)) - 0.25) < 1e-15
print("suq_sin(0.3, 2) =", float(suq_sin(0.3, 2.0, device)),
      "suq_cos(0.3, 2) =", float(suq_cos(0.3, 2.0, device)))
print("composition functions OK")
