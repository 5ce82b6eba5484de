"""Brusselator ODE with FIXED steps across the explicit Runge-Kutta
methods (mirrors russell_ode examples/brusselator_ode_fix_step.rs:
Hairer-Nørsett-Wanner I, Fig 16.4 / Eq 16.12): solve to x1 = 20 with a
range of equal step sizes and tabulate the error against the Mathematica
reference solution; higher-order methods must gain accuracy faster as h
shrinks.

Usage: python examples_torch/ex_ode_brusselator_fix_step.py [--device cuda|cpu]
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

system, x0, y0, args, y_ref = samples.brusselator_ode()
x1 = 20.0
hh = [0.2, 0.1, 0.05, 0.01]
print(f"{'method':>12}" + "".join(f"  h={h:<7g}" for h in hh))
errors = {}
for method in Method.erk_methods():
    params = Params(method)
    solver = OdeSolver(params, system, device)
    row = []
    for h in hh:
        y = solver.solve(y0, x0, x1, h_equal=h, args=args).cpu().numpy()
        err = float(np.max(np.abs(y - y_ref)))
        row.append(err)
    errors[method] = row
    print(f"{method.value:>12}" + "".join(f"  {e:9.2e}" for e in row))

# order shows: at h=0.01 every ERK method beats its own h=0.2 error,
# and DoPri8 at h=0.05 is already near machine precision
for method, row in errors.items():
    assert row[-1] < row[0], f"{method}: no gain from smaller steps"
assert errors[Method.DOPRI8][2] < 1e-10
assert errors[Method.DOPRI5][3] < 1e-9
print("ok")
