"""Method of lines: 1-D heat equation semi-discretized by Chebyshev
spectral collocation, integrated by Radau5 (mirrors
russell_ode/examples/pde_1d_heat_spectral_collocation.rs).

    du/dt = d2u/dx2 on [0,1], u(0)=u(1)=0, u0 = sin(pi x)
    analytic: u(x,t) = exp(-pi^2 t) sin(pi x)

Usage: python examples_torch/ex_ode_pde_heat_spectral_mol.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch

from russell_tpu_torch.algo.interp_lagrange import InterpLagrange
from russell_tpu_torch.ode import Method, OdeSolver, Params, System

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

npt = 16
interp = InterpLagrange(npt - 1)
interp.calc_dd2_matrix()
kk = 4.0 * np.asarray(interp.get_dd2())   # map [-1,1] -> [0,1]: (dr/dx)^2 = 4
interior = np.arange(1, npt - 1)
kbar = torch.as_tensor(kk[np.ix_(interior, interior)], device=device)
x = (1.0 + np.asarray(interp.xx)[interior]) / 2.0
ndim = npt - 2

system = System(ndim, lambda t, y, args: kbar @ y)
ii, jj = np.meshgrid(np.arange(ndim), np.arange(ndim), indexing="ij")
system.set_jacobian((ii.ravel(), jj.ravel()),
                    lambda t, y, args: torch.ravel(kbar))

params = Params(Method.RADAU5)
params.set_tolerances(1e-10, 1e-10)
solver = OdeSolver(params, system, device)
t1 = 0.1
y = solver.solve(np.sin(math.pi * x), 0.0, t1).cpu().numpy()
exact = math.exp(-math.pi ** 2 * t1) * np.sin(math.pi * x)
err = np.max(np.abs(y - exact))
print(solver.stats().summary())
print(f"max |u - exact| at t={t1}: {err:.3e}")
# npt=16 collocation reaches ~1e-9: both space (spectral) and time
# (tol 1e-10) errors are tiny
assert err < 5e-9
print("ok")
