"""Brusselator PDE, SECOND-book variant (periodic BCs; mirrors
russell_ode/examples/brusselator_pde_radau5_2nd.rs at a demo npoint).

Usage: python examples_torch/ex_ode_brusselator_pde_2nd.py [--device cuda|cpu]
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

system, t0, y0, args = samples.brusselator_pde(0.1, 9, second_book=True)
params = Params(Method.RADAU5)
params.set_tolerances(1e-4, 1e-4)
solver = OdeSolver(params, system, device)
y = solver.solve(y0, t0, 1.0, args=None).cpu().numpy()
st = solver.stats()
assert bool(np.all(np.isfinite(y)))
print(f"ndim={2*9*9} steps={st.n_steps} accepted={st.n_accepted} "
      f"jacobians={st.n_jacobian} factorizations={st.n_factor}")
print("u center =", float(y[4 * 9 + 4]))
print("brusselator pde 2nd book OK")
