"""Complex dense linear system + complex zip/unzip round trip
(mirrors russell_lab examples/complex_linear_system_solution_1.rs).

Usage: python examples_torch/ex_lab_complex_linear_system.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.dense import (complex_vec_unzip, complex_vec_zip,
                                     solve_lin_sys)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

a = np.array([[19.73, 12.11 - 1.0j, 0.0, 0.0],
              [-0.51 + 1.0j, 32.3 + 7.0j, 23.07, 0.0],
              [0.0, -0.51 + 1.0j, 70.0 + 7.3j, 3.95],
              [0.0, 0.0, 1.0 + 1.1j, 50.17]], dtype=np.complex128)
b = np.array([77.38 + 8.82j, 157.48 + 19.8j, 1175.62 + 20.69j,
              912.12 - 801.75j], dtype=np.complex128)
xt = solve_lin_sys(a, b, device=device)
x = xt.cpu().numpy()
print("x =", np.round(x, 6))
assert np.max(np.abs(a @ x - b)) < 1e-10

# zip/unzip real<->complex planes
re, im = complex_vec_unzip(xt)
x2 = complex_vec_zip(re, im).cpu().numpy()
assert np.allclose(x2, x)
print("zip/unzip round trip verified")
print("ok")
