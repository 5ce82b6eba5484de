"""Mandel-basis elasticity: strain -> stress -> invariants -> spectral
decomposition (mirrors russell_tensor examples).

Usage: python examples_torch/ex_tensor_elasticity.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.tensor import LinElasticity, Mandel, Spectral2, Tensor2

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

eps = Tensor2.from_matrix(np.array([[1e-3, 2e-4, 0.0],
                                    [2e-4, -5e-4, 1e-4],
                                    [0.0, 1e-4, 2e-4]]), Mandel.SYMMETRIC,
                          device=device)
le = LinElasticity(young=210e3, poisson=0.3, device=device)
sig = le.calc_stress(eps)
print("sigma_m =", float(sig.invariant_sigma_m()))
print("sigma_d =", float(sig.invariant_sigma_d()))
sp = Spectral2(device=device).decompose(sig)
print("principal stresses:", np.sort(sp.lambdas.cpu().numpy()))
back = sp.compose(sp.lambdas)
assert float(torch.max(torch.abs(back.vec - sig.vec))) < 1e-9
print("ok")
