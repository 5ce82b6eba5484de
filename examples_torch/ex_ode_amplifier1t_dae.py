"""One-transistor amplifier DAE (singular mass matrix) via Radau5,
matching the radau5.f counters and solution exactly
(mirrors russell_ode examples/amplifier1t_radau5.rs).

Usage: python examples_torch/ex_ode_amplifier1t_dae.py [--device cuda|cpu]
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

system, x0, y0, args = samples.amplifier1t()
params = Params(Method.RADAU5)
params.step.h_ini = 1e-6
params.set_tolerances(1e-4, 1e-4)
solver = OdeSolver(params, system, device)
y = solver.solve(y0, x0, 0.05, args=args).cpu().numpy()
st = solver.stats()
print(st.summary())
print("y =", np.round(y, 9))
assert abs(y[0] - (-2.226517868073645e-02)) < 1e-10
assert abs(y[1] - 3.068700099735197e+00) < 1e-10
assert abs(y[4] - (-2.269179823457655e+00)) < 1e-7
assert (st.n_steps, st.n_accepted, st.n_rejected) == (166, 127, 6)
assert (st.n_function, st.n_jacobian) == (1511, 126)
print("ok")
