"""Arenstorf orbit (restricted three-body) with DoPri8, matching the
reference Fortran oracle counters (mirrors russell_ode
examples/arenstorf_dopri8.rs).

Usage: python examples_torch/ex_ode_arenstorf_dopri8.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.ode import Method, OdeSolver, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, x1, args, y_ref = samples.arenstorf()
params = Params(Method.DOPRI8)
params.set_tolerances(1e-7, 1e-7)
solver = OdeSolver(params, system, device)
y = solver.solve(y0, x0, x1, args=args)
st = solver.stats()
print(st.summary())
yh = y.cpu().numpy()
print("y(end) =", yh)
# the orbit is periodic: y(end) ~ y(0)
y0h = np.asarray(y0, dtype=float)
assert abs(yh[0] - float(y0h[0])) < 2e-3
assert abs(yh[1] - float(y0h[1])) < 2e-3
print("ok")
