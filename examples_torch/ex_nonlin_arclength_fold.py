"""Pseudo-arclength continuation through the Bank-Mittelmann fold
(mirrors russell_nonlin examples).

Usage: python examples_torch/ex_nonlin_arclength_fold.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

from russell_tpu_torch.nonlin import (Config, DeltaLambda, IniDir, Method,
                                      Output, Solver, Stop, samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, u0, l0, lam_ana = samples.one_eq_with_fold_point()
solver = Solver(Config(method=Method.ARCLENGTH), system, device)
out = Output().set_recording([0])
u, l, status = solver.solve(u0, l0, IniDir.POS, Stop.max_comp_u(0, 3.0),
                            DeltaLambda.constant(0.05), output=out)
assert status.success()
print(f"passed the fold at lambda = 1/e = {1/math.e:.4f}; "
      f"reached u = {float(u[0]):.3f}, lambda = {l:.4f}")
for ui, li in zip(out.step_u(0)[::5], out.step_l[::5]):
    print(f"  u = {ui:7.3f}  lambda = {li:8.5f}")
    assert abs(lam_ana(ui) - li) < 1e-7
print("ok")
