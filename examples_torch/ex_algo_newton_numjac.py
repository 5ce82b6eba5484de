"""Newton-Raphson on a 2-equation system, analytic vs numerical Jacobian
(mirrors russell_lab examples/algo_newton_solver.rs +
algo_numerical_jacobian.rs).

Usage: python examples_torch/ex_algo_newton_numjac.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.algo import NewtonSolver, num_jacobian

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# intersect circle x^2+y^2=4 with hyperbola xy=1
def residual(x, u, args):
    u = torch.as_tensor(u)
    return torch.stack([u[0] ** 2 + u[1] ** 2 - 4.0, u[0] * u[1] - 1.0])


def jacobian(x, u, args):
    u = torch.as_tensor(u)
    return torch.stack([torch.stack([2.0 * u[0], 2.0 * u[1]]),
                        torch.stack([u[1], u[0]])])


# check the numerical Jacobian against the analytic one first
u0 = np.array([2.0, 0.5])
J_num = np.asarray(num_jacobian(residual, 0.0, u0, None))
J_ana = jacobian(0.0, u0, None).numpy()
print("max|J_num - J_ana| =", np.max(np.abs(J_num - J_ana)))
assert np.max(np.abs(J_num - J_ana)) < 1e-6

solver = NewtonSolver(2).set_enable_stats(True)
u = solver.solve(u0, residual, jacobian, device=device).cpu().numpy()
st = solver.get_stats()
print(f"analytic jac:  u = {u}  iterations = {st.n_iterations}")
assert abs(u[0] ** 2 + u[1] ** 2 - 4.0) < 1e-10
assert abs(u[0] * u[1] - 1.0) < 1e-10

solver2 = NewtonSolver(2)
solver2.use_numerical_jacobian = True
u2 = solver2.solve(u0, residual, device=device).cpu().numpy()
print(f"numerical jac: u = {u2}")
assert np.max(np.abs(u2 - u)) < 1e-8
print("ok")
