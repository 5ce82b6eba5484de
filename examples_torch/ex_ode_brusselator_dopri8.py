"""Brusselator ODE with DoPri8 dense output, compared against the
reference Mathematica solution at tf = 20
(mirrors russell_ode examples/brusselator_ode_dopri8.rs).

Usage: python examples_torch/ex_ode_brusselator_dopri8.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args, y_ref = samples.brusselator_ode()
params = Params(Method.DOPRI8)
params.set_tolerances(1e-8, 1e-8)
solver = OdeSolver(params, system, device)
out = Output().set_dense_h_out(1.0).set_dense_recording([0, 1])
y = solver.solve(y0, x0, 20.0, args=args, output=out).cpu().numpy()
st = solver.stats()
print(st.summary())
print(f"y(20) = ({float(y[0]):.10f}, {float(y[1]):.10f})")
print(f"ref   = ({y_ref[0]:.10f}, {y_ref[1]:.10f})")
assert np.allclose(y, np.asarray(y_ref), atol=1e-7)
# the dense output must bracket the final state consistently
assert len(out.dense_x()) == len(out.dense_y(0)) == 21
print("ok")
