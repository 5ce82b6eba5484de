"""Simplest possible ODE: y' = x + y with one equation, solved by DoPri8
and checked against the analytical solution
(mirrors russell_ode examples/simple_ode_single_equation.rs).

Usage: python examples_torch/ex_ode_single_equation.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import torch

from russell_tpu_torch.ode import Method, OdeSolver, Params, System

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# y' = x + y,  y(0) = 0  =>  y = e^x - x - 1
system = System(1, lambda x, y, args: x + y)
params = Params(Method.DOPRI8)
solver = OdeSolver(params, system, device)
y = solver.solve(torch.zeros(1, dtype=torch.float64), 0.0, 1.0)
st = solver.stats()
print(st.summary())
exact = math.e - 2.0
print(f"y(1) = {float(y[0]):.12f}, exact = {exact:.12f}")
assert abs(float(y[0]) - exact) < 1e-7
print("ok")
