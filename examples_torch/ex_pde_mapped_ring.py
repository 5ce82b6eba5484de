"""Spectral collocation on a MAPPED domain: Laplace on a quarter annulus
via transfinite interpolation, with spectral convergence in the node count
(mirrors russell_pde examples/spc_map_2d.rs usage of Transfinite2d +
SpcMap2d).

Usage: python examples_torch/ex_pde_mapped_ring.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np

from russell_tpu_torch.pde import (EssentialBcs2d, NaturalBcs2d, Side,
                                   SpcMap2d, Transfinite2d)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# quarter annulus r in [1, 2], theta in [0, pi/2]
a, b = 1.0, 2.0


def th(s):
    return (s + 1.0) * math.pi / 4.0


B = [lambda s: np.array([a * math.cos(th(s)), a * math.sin(th(s))]),
     lambda s: np.array([b * math.cos(th(s)), b * math.sin(th(s))]),
     lambda r: np.array([(a + b) / 2 + (b - a) / 2 * r, 0.0]),
     lambda r: np.array([0.0, (a + b) / 2 + (b - a) / 2 * r])]
dB = [lambda s: np.array([-a * math.sin(th(s)) * math.pi / 4,
                          a * math.cos(th(s)) * math.pi / 4]),
      lambda s: np.array([-b * math.sin(th(s)) * math.pi / 4,
                          b * math.cos(th(s)) * math.pi / 4]),
      lambda r: np.array([(b - a) / 2, 0.0]),
      lambda r: np.array([0.0, (b - a) / 2])]
ddB = [lambda s: np.array([-a * math.cos(th(s)) * (math.pi / 4) ** 2,
                           -a * math.sin(th(s)) * (math.pi / 4) ** 2]),
       lambda s: np.array([-b * math.cos(th(s)) * (math.pi / 4) ** 2,
                           -b * math.sin(th(s)) * (math.pi / 4) ** 2]),
       lambda r: np.array([0.0, 0.0]),
       lambda r: np.array([0.0, 0.0])]
trans = Transfinite2d(B, dB, ddB)


# exact harmonic solution phi = ln(r)/ln(2): 0 on inner, 1 on outer radius
def ana(x, y):
    return math.log(math.hypot(x, y)) / math.log(2.0)


errors = []
for nn in (5, 9, 13):
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: 0.0)
    ebcs.set(Side.XMAX, lambda x, y: 1.0)
    ebcs.set(Side.YMIN, ana)
    ebcs.set(Side.YMAX, ana)
    spc = SpcMap2d(nn, nn, trans, ebcs, NaturalBcs2d(), k=1.0, device=device)
    sol = spc.solve_sps(0.0, lambda x, y: 0.0)
    err = 0.0

    def cb(m, x, y):
        global err
        err = max(err, abs(sol[m] - ana(x, y)))
    spc.for_each_coord(cb)
    errors.append(err)
    print(f"n = {nn:2d}  max err = {err:.3e}")

# spectral (exponential) convergence: each refinement gains >= 100x
assert errors[1] < errors[0] / 100.0
assert errors[2] < 1e-9
print("ok")
