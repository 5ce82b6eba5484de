"""Same Poisson problem solved by finite differences AND spectral
collocation: the dual-method validation pattern of the reference
(russell_pde tests/test_2d_prob01_{fdm,spc}.rs).

Usage: python examples_torch/ex_pde_fdm_vs_spc.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.pde import Fdm2d, Grid2d, Spc2d, problem_samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def max_err(solver, a, analytical):
    err = 0.0

    def cb(m, x, y):
        nonlocal err
        err = max(err, abs(a[m] - analytical(x, y)))
    solver.for_each_coord(cb)
    return err


(xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, source, analytical,
 _flow) = problem_samples.d2_problem_01(case_a=True)

# FDM: 2nd-order 5-point molecule, error ~ h^2 (4x drop per halving)
errs = []
for npt in (11, 21, 41):
    grid = Grid2d.new_uniform(xmin, xmax, ymin, ymax, npt, npt)
    fdm = Fdm2d(grid, ebcs, nbcs, kx, ky, device=device)
    a = fdm.solve_sps(0.0, source)
    errs.append(max_err(fdm, a, analytical))
print("FDM max errors (h -> h/2 -> h/4):", [f"{e:.2e}" for e in errs])
assert errs[1] < errs[0] / 3 and errs[2] < errs[1] / 3

# SPC: Chebyshev-Lobatto collocation, spectral (exponential) accuracy:
# 12x12 points beat the 41x41 FDM by ~5 orders of magnitude
spc = Spc2d(xmin, xmax, ymin, ymax, 12, 12, ebcs, nbcs, kx, ky,
            device=device)
a_s = spc.solve_sps(0.0, source)
err_s = max_err(spc, a_s, analytical)
print(f"SPC max error at 12x12 points: {err_s:.2e}")
assert err_s < 1e-9
print("ok")
