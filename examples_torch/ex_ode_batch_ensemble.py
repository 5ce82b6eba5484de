"""Ensemble integration: many stiff ODEs with independent adaptive
stepping in ONE device computation (the fused Radau5 over a batch of
lanes).

Usage: python examples_torch/ex_ode_batch_ensemble.py [--device cuda|cpu]
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

system, x0, y0, x1, args = samples.van_der_pol(1e-4, False)
solver = OdeSolver(Params(Method.RADAU5), system, device)
B = 32
y0s = np.tile(np.asarray(y0, dtype=float)[None, :], (B, 1))
y0s[:, 0] += np.linspace(-0.5, 0.5, B)
ys, st = solver.solve_batch(y0s, x0, 1.0)
acc = st["n_accepted"].cpu().numpy()
print(f"{B} stiff integrations in one computation; "
      f"steps per lane: min={acc.min()} max={acc.max()}")
assert np.all(st["status"].cpu().numpy() == 1)
print("ok")
