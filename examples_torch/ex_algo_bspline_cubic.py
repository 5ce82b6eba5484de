"""B-spline curves and the closed-form cubic solver
(mirrors russell_lab Bspline doc surface and the solve_cubic helper
used by the fold-tracking continuation in russell_nonlin).

Usage: python examples_torch/ex_algo_bspline_cubic.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.algo import Bspline, solve_cubic

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# clamped quadratic B-spline through 4 control points
p = 2
uu = [0.0, 0.0, 0.0, 0.5, 1.0, 1.0, 1.0]
bs = Bspline(p, uu)
assert bs.num_basis() == 4
ctrl = np.array([[0.0, 0.0], [0.5, 1.2], [1.5, 1.2], [2.0, 0.0]])
bs.set_control_points(ctrl)

# clamped ends interpolate the control polygon endpoints
assert np.allclose(bs.calc_point(0.0), ctrl[0])
assert np.allclose(bs.calc_point(1.0), ctrl[-1])
# basis functions form a partition of unity everywhere
for u in (0.1, 0.4, 0.77):
    bs.calc_basis(u)
    assert abs(sum(bs.get_basis(i) for i in range(4)) - 1.0) < 1e-14
# tangent via analytic curve derivatives vs finite differences
d = bs.calc_curve_derivs(0.35, 1)
h = 1e-7
fd = (bs.calc_point(0.35 + h) - bs.calc_point(0.35 - h)) / (2 * h)
assert np.allclose(d[1], fd, atol=1e-5)
print("curve(0.35) =", d[0], " tangent =", d[1])

# cubic roots, closed-form (Cardano with the trigonometric 3-real case)
roots = solve_cubic(1.0, -6.0, 11.0, -6.0)
assert np.allclose(roots, [1.0, 2.0, 3.0], atol=1e-10)
roots1 = solve_cubic(1.0, 0.0, 1.0, 1.0)
assert len(roots1) == 1 and abs(roots1[0] + 0.6823278038280193) < 1e-12
print("roots of (x-1)(x-2)(x-3):", roots)
print("bspline/cubic OK")
