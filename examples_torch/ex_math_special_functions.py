"""Special functions: a Bessel field evaluated as one vectorized call on
the device + the elliptic arc length (mirrors russell_lab math examples).

Usage: python examples_torch/ex_math_special_functions.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch import math as rm

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

xs = np.linspace(0.0, 40.0, 9)
j0 = torch.vmap(rm.bessel_j0)(torch.as_tensor(xs, device=device))
for x, v in zip(xs, j0.cpu().numpy()):
    print(f"J0({x:5.1f}) = {v: .12f}")
L = 4 * 2 * float(rm.elliptic_e(np.pi / 2, 1 - 0.25, device))
print("ellipse (a=2,b=1) perimeter =", L)
assert abs(L - 9.688448220547675) < 1e-10
print("ok")
