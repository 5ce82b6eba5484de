"""Brusselator reaction-diffusion PDE solved by Radau5, the flagship
workload at acceptance scale (mirrors russell_ode
examples/brusselator_pde_radau5.rs and brusselator_pde_2nd_comparison.rs;
HW-II Fig 10.7). The method-of-lines system (ndim = 2·npoint²) carries a
sparse 5-point-molecule Jacobian; AUTO routes its factorization to the
grid multifrontal (GRIDMF), whose pivot blocks the ``gj_inv`` kernel
inverts. The fused loop runs the whole integration on the device.

Usage: python examples_torch/ex_ode_brusselator_pde_radau5.py
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

npoint = 9
alpha = 2e-3
system, t0, yy0, args = samples.brusselator_pde(alpha, npoint)
ndim = 2 * npoint * npoint
print(f"ndim = {ndim}, jac_nnz = {system.jac_nnz}")

params = Params(Method.RADAU5)
params.set_tolerances(1e-4, 1e-4)
solver = OdeSolver(params, system, device)
y = solver.solve(yy0, t0, 1.0, args=args, fused=True)
st = solver.stats()
print(st.summary())

yh = y.cpu().numpy()
u = yh[: npoint * npoint]
v = yh[npoint * npoint:]
print(f"u in [{u.min():.6f}, {u.max():.6f}], "
      f"v in [{v.min():.6f}, {v.max():.6f}]")
assert np.all(np.isfinite(yh))
assert st.n_steps > 5 and st.n_factor >= 1
# diffusion keeps both species in the reaction range (HW-II Fig 10.7:
# bounded by the sin/cos initial data peaks ~5 at t=1)
assert 0.0 < u.min() and u.max() < 5.5
assert 0.0 < v.min() and v.max() < 5.5

# second-book variant (periodic BCs + inhomogeneity, HW-II Eq 10.12)
system2, t02, yy02, args2 = samples.brusselator_pde(
    0.1, npoint, second_book=True)
solver2 = OdeSolver(params, system2, device)
y2 = solver2.solve(yy02, t02, 1.0, args=args2, fused=True)
assert np.all(np.isfinite(y2.cpu().numpy()))
print("second book:", solver2.stats().summary())
print("ok")
