"""MatrixMarket I/O round trip + vismatrix (.smat) export (mirrors
russell_sparse read_matrix_market.rs / write_matrix_market.rs doc
examples). The matrix is written here first: a symmetric 62 x 62 band
stored as its lower triangle (the MMsym storage of bfwb62.mtx), read
back, solved and verified like solve_matrix_market does.

Usage: python examples_torch/ex_sparse_matrix_market_io.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np

from russell_tpu_torch.sparse import (CooMatrix, LinSolver, Sym, VerifyLinSys,
                                      read_matrix_market, write_matrix_market)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

n = 62
rng = np.random.default_rng(62)
ii, jj, vv = [], [], []
for i in range(n):
    for j in range(max(0, i - 3), i + 1):      # lower triangle, bandwidth 3
        ii.append(i)
        jj.append(j)
        vv.append(8.0 + rng.random() if i == j else rng.random() - 0.5)
lower = CooMatrix.from_arrays(n, n, np.asarray(ii), np.asarray(jj),
                              np.asarray(vv), sym=Sym.YES_LOWER)

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "band62.mtx")
    write_matrix_market(lower, path)
    # read the fixture (symmetric storage handled via MMsym)
    coo, _ = read_matrix_market(path)
    print("band62:", coo.nrow, "x", coo.ncol, "nnz:", coo.nnz, "sym:", coo.sym)
    assert (coo.nrow, coo.ncol) == (62, 62)

    # solve it and verify the residual like solve_matrix_market does
    sol = LinSolver(device=device)
    sol.factorize(coo)
    b = np.ones(coo.nrow)
    x = sol.solve(b).cpu().numpy()
    v = VerifyLinSys.from_system(coo, x, b)
    print(f"relative_error: {v.relative_error:.3e}")
    assert v.relative_error < 1e-10

    # write -> read round trip preserves the matrix exactly
    out = os.path.join(d, "roundtrip.mtx")
    write_matrix_market(coo, out)
    coo2, _ = read_matrix_market(out)
    # writer emits %.15e-style text: equal to ~1 ulp, not bit-exact
    assert np.allclose(coo.as_dense(), coo2.as_dense(),
                       rtol=1e-14, atol=1e-300)
    # vismatrix export (.smat) for visual inspection
    write_matrix_market(coo, os.path.join(d, "viz.smat"), vismatrix=True)
    assert os.path.getsize(os.path.join(d, "viz.smat")) > 0
print("ok")
