"""Hairer-Wanner Eq.(1.1) test equation: DoPri5 with dense output and
Radau5 on the same problem, both matching the Fortran counters
(mirrors russell_ode examples/hairer_wanner_eq1.rs).

Usage: python examples_torch/ex_ode_hairer_wanner_eq1.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()

# DoPri5 with dense output every 0.1 (dopri5.f oracle counters)
params = Params(Method.DOPRI5)
params.step.h_ini = 1e-4
solver = OdeSolver(params, system, device)
out = Output().set_dense_h_out(0.1).set_dense_recording([0])
y = solver.solve(y0, x0, 1.5, args=args, output=out)
st = solver.stats()
print("DoPri5:", st.summary())
assert (st.n_function, st.n_steps, st.n_rejected) == (235, 39, 0)
assert abs(float(y[0]) - 9.063921649310544e-02) < 1e-13
for xo, yo in zip(out.dense_x(), out.dense_y(0)):
    exact = float(y_fn(xo, None)[0])
    assert abs(yo - exact) < 1e-4

# Radau5 on the same problem (radau5.f oracle)
params2 = Params(Method.RADAU5)
solver2 = OdeSolver(params2, system, device)
y2 = solver2.solve(y0, x0, 1.5, args=args)
st2 = solver2.stats()
print("Radau5:", st2.summary())
assert abs(float(y2[0]) - float(y_fn(1.5, None)[0])) < 2e-4
print("ok")
