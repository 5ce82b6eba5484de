"""Stiffness detection: DoPri5 on a stiffening van der Pol raises a
StiffnessError (HW-II Eq. 2.26 ratio test), and Radau5 then solves the
same problem without complaint
(mirrors russell_ode examples/van_der_pol_dopri5_stiffness.rs).

Usage: python examples_torch/ex_ode_stiffness_detection.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.ode import (Method, OdeSolver, Params, StiffnessError,
                                   samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, x1, args = samples.van_der_pol(0.003, False)

# explicit DoPri5: the stiffness monitor must fire
params = Params(Method.DOPRI5)
params.set_tolerances(1e-5, 1e-5)
params.stiffness.enabled = True
solver = OdeSolver(params, system, device)
try:
    solver.solve(y0, x0, 2.0, args=args)
    raise SystemExit("expected StiffnessError")
except StiffnessError as e:
    print(f"DoPri5 detected stiffness as expected: {e}")

# implicit Radau5 handles it
params2 = Params(Method.RADAU5)
params2.set_tolerances(1e-5, 1e-5)
solver2 = OdeSolver(params2, system, device)
y = solver2.solve(y0, x0, 2.0, args=args).cpu().numpy()
st = solver2.stats()
print(f"Radau5: y(2.0) = {y}  steps = {st.n_steps} "
      f"(accepted {st.n_accepted})")
assert np.all(np.isfinite(y))
assert st.n_steps < 1000
print("ok")
