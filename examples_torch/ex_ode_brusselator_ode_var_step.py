"""Brusselator ODE with variable-step DoPri8 vs fixed-step RK4
(mirrors russell_ode/examples/brusselator_ode_var_step.rs and
brusselator_ode_fix_step.rs; y_ref from Mathematica).

Usage: python examples_torch/ex_ode_brusselator_ode_var_step.py
       [--device cuda|cpu]
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

# variable step: embedded error control picks the step sizes
params = Params(Method.DOPRI8)
params.set_tolerances(1e-8, 1e-8)
sol = OdeSolver(params, system, device)
y = sol.solve(y0, x0, 20.0, args=args).cpu().numpy()
st = sol.stats()
print("DoPri8 var-step:", y, "n_steps:", st.n_steps)
assert np.max(np.abs(y - y_ref)) < 1e-7

# fixed step: the classic RK4 with h chosen by the user
params2 = Params(Method.RK4)
sol2 = OdeSolver(params2, system, device)
y2 = sol2.solve(y0, x0, 20.0, args=args, h_equal=0.002).cpu().numpy()
print("RK4 fixed-step:", y2, "n_steps:", sol2.stats().n_steps)
assert np.max(np.abs(y2 - y_ref)) < 1e-7
print("ok")
