"""Hand-rolled Newton iteration on a 4-equation nonlinear system with a
16-nnz sparse Jacobian, factorized by each native genie
(mirrors russell_sparse examples/nonlinear_system_4eqs.rs).

Usage: python examples_torch/ex_sparse_nonlinear_4eqs.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import CooMatrix, Genie, LinSolver

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def residual(u):
    d1, d2, d3, d4 = u
    return np.array([
        2.0 * d1 + d1 ** 4 + d2 + 3.0 * d1 * d2 * d2 - 9.0 * d4
        + d4 ** 4 - 0.2,
        d1 + 3.0 * d1 * d1 * d2 + 10.0 * d2 + 4.0 * d2 * d2
        + 2.0 * d2 * d3 - 8.0 * d3 + 7.0 * d4 + 0.1,
        -8.0 * d2 + d2 * d2 + 3.0 * d3 + d3 * d3 + 2.0 * d4,
        -9.0 * d1 + 4.0 * d1 * d4 ** 3 + 7.0 * d2 + 2.0 * d3
        + 5.0 * d4 - 0.5,
    ])


def jacobian(jj: CooMatrix, u):
    d1, d2, d3, d4 = u
    jj.reset()
    jj.put(0, 0, 2.0 + 4.0 * d1 ** 3 + 3.0 * d2 * d2)
    jj.put(0, 1, 1.0 + 6.0 * d1 * d2)
    jj.put(0, 2, 0.0)
    jj.put(0, 3, -9.0 + 4.0 * d4 ** 3)
    jj.put(1, 0, 1.0 + 6.0 * d1 * d2)
    jj.put(1, 1, 10.0 + 3.0 * d1 * d1 + 8.0 * d2 + 2.0 * d3)
    jj.put(1, 2, -8.0 + 2.0 * d2)
    jj.put(1, 3, 7.0)
    jj.put(2, 0, 0.0)
    jj.put(2, 1, -8.0 + 2.0 * d2)
    jj.put(2, 2, 3.0 + 2.0 * d3)
    jj.put(2, 3, 2.0)
    jj.put(3, 0, -9.0 + 4.0 * d4 ** 3)
    jj.put(3, 1, 7.0)
    jj.put(3, 2, 2.0)
    jj.put(3, 3, 5.0 + 12.0 * d1 * d4 * d4)


for genie in (Genie.DENSE, Genie.SPLU):
    solver = LinSolver(genie, device=device)
    jj = CooMatrix(4, 4, 16)
    u = np.zeros(4)
    norm0 = None
    print(f"--- {genie.value} ---")
    print(f"{'it':>4}{'d1':>13}{'d2':>13}{'d3':>13}{'d4':>13}{'err':>15}")
    for it in range(10):
        rr = residual(u)
        if norm0 is None:
            norm0, err = float(np.linalg.norm(rr)), 1.0
        else:
            err = float(np.linalg.norm(rr)) / norm0
        print(f"{it:>4}{u[0]:>13.6f}{u[1]:>13.6f}{u[2]:>13.6f}"
              f"{u[3]:>13.6f}{err:>15.6e}")
        if err < 1e-13:
            break
        # factorize the fresh Jacobian (structure frozen across iterations)
        jacobian(jj, u)
        solver.factorize(jj)
        u = u - solver.solve(rr).cpu().numpy()
    assert err < 1e-13, "Newton did not converge"
    assert np.max(np.abs(residual(u))) < 1e-12
print("ok")
