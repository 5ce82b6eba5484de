"""Brusselator PDE solver-backend comparison (mirrors
russell_ode/examples/brusselator_pde_2nd_comparison.rs: same problem
through different linear-solver genies; solutions and step counters
must agree).

Usage: python examples_torch/ex_ode_brusselator_pde_comparison.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
from russell_tpu_torch.sparse.enums import Genie

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

results = {}
for genie in (Genie.BANDED, Genie.SPLU):
    system, t0, y0, args = samples.brusselator_pde(2e-3, 9)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = genie
    solver = OdeSolver(params, system, device)
    y = solver.solve(y0, t0, 1.0, args=None).cpu().numpy()
    st = solver.stats()
    results[genie.value] = (y, st.n_steps, st.n_accepted)
    print(f"{genie.value:>8}: n_steps={st.n_steps} "
          f"n_accepted={st.n_accepted} y[0]={float(y[0]):.8f}")

ys = list(results.values())
assert ys[0][1] == ys[1][1], "step counters must match across genies"
assert np.max(np.abs(ys[0][0] - ys[1][0])) < 1e-8
print("backend comparison OK")
