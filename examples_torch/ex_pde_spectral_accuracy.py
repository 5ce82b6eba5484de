"""Spectral collocation vs FDM on the same Poisson problem (mirrors
russell_pde tests/test_2d_prob01_{fdm,spc}.rs).

Usage: python examples_torch/ex_pde_spectral_accuracy.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.pde import Fdm2d, Grid2d, Spc2d, problem_samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

(xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, ana, flow) = \
    problem_samples.d2_problem_01(True)
grid = Grid2d.new_uniform(xmin, xmax, ymin, ymax, 41, 41)
fdm = Fdm2d(grid, ebcs, nbcs, kx, ky, device=device)
a_fdm = fdm.solve_sps(0.0, src)

(xmin, xmax, ymin, ymax, kx, ky, e2, n2, src, ana, flow) = \
    problem_samples.d2_problem_01(True)
spc = Spc2d(xmin, xmax, ymin, ymax, 14, 14, e2, n2, kx, ky, device=device)
a_spc = spc.solve_sps(0.0, src)


def max_err(solver, a):
    err = [0.0]
    solver.for_each_coord(lambda m, x, y: err.__setitem__(
        0, max(err[0], abs(a[m] - ana(x, y)))))
    return err[0]


e1, e2v = max_err(fdm, a_fdm), max_err(spc, a_spc)
print(f"FDM 41x41 err = {e1:.2e}   SPC 14x14 err = {e2v:.2e}")
assert e1 < 1e-4 and e2v < 1e-10
print("ok")
