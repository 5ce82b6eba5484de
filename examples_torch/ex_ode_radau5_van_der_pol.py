"""Stiff van der Pol via Radau5, matching radau5.f statistics exactly
(mirrors russell_ode tests/test_radau5_van_der_pol.rs).

Usage: python examples_torch/ex_ode_radau5_van_der_pol.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.ode import Method, OdeSolver, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
params = Params(Method.RADAU5)
params.step.h_ini = 1e-6
solver = OdeSolver(params, system, device)
y = solver.solve(y0, x0, x1, fused=True)
st = solver.stats()
print(st.summary())
assert (st.n_function, st.n_jacobian, st.n_steps) == (2249, 162, 280)
assert abs(float(y[0]) - 1.706163410178079) < 1e-12
print("ok")
