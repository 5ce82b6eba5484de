"""Dense numerical Jacobian vs analytical (mirrors
russell_lab/examples/algo_numerical_jacobian.rs).

Usage: python examples_torch/ex_algo_numerical_jacobian.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.algo import num_jacobian

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def f(x, u, _args=None):
    u = torch.as_tensor(u, device=device)
    return torch.stack([
        2.0 * u[0] - u[1] + torch.sin(x * u[2]),
        u[0] * u[1] - 3.0 * u[2],
        u[0] + u[1] + u[2] ** 2,
    ])


x = 0.5
u = np.asarray([1.0, 2.0, 0.5])
J = np.asarray(num_jacobian(f, x, u))
J_exact = np.asarray([
    [2.0, -1.0, x * np.cos(x * u[2])],
    [u[1], u[0], -3.0],
    [1.0, 1.0, 2.0 * u[2]],
])
err = np.max(np.abs(J - J_exact))
print("J =\n", np.array2string(J, precision=6))
print("max|J - J_exact| =", err)
assert err < 1e-7
print("numerical jacobian OK")
