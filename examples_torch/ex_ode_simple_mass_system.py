"""ODE system with a mass matrix, solved by Radau5
(mirrors russell_ode examples/simple_system_with_mass.rs).

Usage: python examples_torch/ex_ode_simple_mass_system.py [--device cuda|cpu]
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

system, x0, y0, args, y_fn_x = samples.simple_system_with_mass_matrix()
params = Params(Method.RADAU5)
params.set_tolerances(1e-8, 1e-8)
solver = OdeSolver(params, system, device)
x1 = 20.0
y = solver.solve(y0, x0, x1, args=args)
st = solver.stats()
print(st.summary())
yh = y.cpu().numpy()
# analytic solution: y = (cos x, -sin x, ln(1+x))
expect = np.asarray(y_fn_x(x1, args), dtype=float)
err = np.max(np.abs(yh - expect))
print(f"y({x1}) = {yh}  max err = {err:.2e}")
assert err < 1e-6
print("ok")
