"""Pseudo-arclength continuation along a snap-back B-spline curve:
G(u, lambda) = u - C(lambda) where C is a degree-2 B-spline whose control
point P3 snaps back, creating sharp turning points
(mirrors russell_nonlin examples/arclength_bspline.rs).

Usage: python examples_torch/ex_nonlin_arclength_bspline.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.nonlin import (Config, DeltaLambda, IniDir, Method,
                                      Output, Solver, Stop, samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, u0, l0, curve = samples.bspline_problem_1(1.5)
config = Config(method=Method.ARCLENGTH)
config.bordering = False          # standard un-bordered formulation
config.tg_control_tol = 0.2       # more steps in highly-curved regions
solver = Solver(config, system, device)
out = Output().set_recording([0, 1])
u, l, status = solver.solve(u0, l0, IniDir.POS, Stop.max_lambda(1.0),
                            DeltaLambda.auto(0.01), output=out)
assert status.success()
print(f"traced the branch to lambda = {l:.4f} in "
      f"{len(out.step_l)} accepted steps")

# every recorded point must sit on the B-spline curve: u == C(lambda)
for ux, uy, li in zip(out.step_u(0), out.step_u(1), out.step_l):
    cx, cy = curve(min(1.0, max(0.0, li)))
    assert abs(ux - cx) < 1e-6 and abs(uy - cy) < 1e-6
end = curve(1.0)
u = np.asarray(u)
print(f"end of curve: u = ({float(u[0]):.4f}, {float(u[1]):.4f}), "
      f"C(1) = ({end[0]:.4f}, {end[1]:.4f})")
assert np.allclose(u, end, atol=1e-8)
print("ok")
