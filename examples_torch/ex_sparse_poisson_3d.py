"""3-D Poisson solve through the GRIDMF multifrontal engine: the grid
hint routes a 7-point stencil operator to the batched nested-dissection
path, whose pivot blocks the ``gj_inv`` kernel inverts; verify +
determinant-free stats (mirrors the reference's 3-D FEM/FDM benchmark
class, russell_sparse/data/logs/pres-cylin-3d-*.json).

Usage: python examples_torch/ex_sparse_poisson_3d.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                      VerifyLinSys, samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

npoint = 16   # acceptance size; samples.laplacian_3d(79) runs out of core
coo = samples.laplacian_3d(npoint, conv=0.3)      # unsymmetric
print(f"n = {coo.nrow:,}  nnz = {coo.nnz:,}")

sol = LinSolver(Genie.GRIDMF, device=device)
sol.factorize(coo, LinSolParams(grid=(npoint, npoint, npoint, 1)))
assert sol.stats.output["effective_ordering"] == "nd-grid"

b = np.ones(coo.nrow)
x = sol.solve(b).cpu().numpy()
v = VerifyLinSys.from_system(coo, x, b)
print("relative_error =", v.relative_error)
assert v.relative_error < 1e-10

# interior maximum of the solution sits near the cube center
xi = x.reshape(npoint, npoint, npoint)
c = npoint // 2
imax = np.unravel_index(np.argmax(xi), xi.shape)
assert all(abs(i - c) <= npoint // 4 for i in imax), imax
print("u(center) =", float(xi[c, c, c]), "argmax =", imax)
print("poisson 3d OK")
