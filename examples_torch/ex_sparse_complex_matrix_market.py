"""Complex Matrix Market round trip + complex sparse solve: write a
complex COO matrix to .mtx, read it back, factorize and verify
(mirrors russell_sparse complex MM I/O (read/write_matrix_market.rs)
and examples/doc_complex_umfpack_quickstart_coo.rs).

Usage: python examples_torch/ex_sparse_complex_matrix_market.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np

from russell_tpu_torch.sparse import (CooMatrix, Genie, LinSolver,
                                      VerifyLinSys, read_matrix_market,
                                      write_matrix_market)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# the UMFPACK complex quickstart system
n = 5
ii = np.array([0, 0, 1, 1, 2, 2, 2, 3, 4, 4, 4, 4])
jj = np.array([0, 1, 0, 2, 1, 2, 3, 2, 1, 2, 3, 4])
vv = np.array([2 + 1j, 3 - 1j, 3 + 0.5j, 4 - 2j, -1 + 0j, -3 + 2j,
               2 + 0.3j, 1 - 1j, 4 + 0j, 2 - 1j, -2 + 0j, 6 + 3j])
coo = CooMatrix.from_arrays(n, n, ii, jj, vv)

with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "complex5.mtx")
    write_matrix_market(coo, path)
    with open(path) as fh:
        head = fh.readline()
    assert "complex" in head, head
    # read returns (real, complex): exactly one is set
    _real, coo2 = read_matrix_market(path)
    assert _real is None and coo2 is not None
    d1 = np.asarray(coo.as_dense())
    d2 = np.asarray(coo2.as_dense())
    assert np.allclose(d1, d2), "round trip must be exact"

# factorize + solve the complex system; verify componentwise
sol = LinSolver(Genie.AUTO, device=device)
sol.factorize(coo2)
b = np.arange(1, n + 1).astype(complex) * (1 + 0.25j)
x = sol.solve(b).cpu().numpy()
v = VerifyLinSys.from_system(coo2, x, b)
assert v.relative_error < 1e-10, v.relative_error

# determinant against the dense oracle
mant, base, expo = sol.determinant()
det = mant * base ** expo
assert abs(det - np.linalg.det(d1)) < 1e-8 * abs(np.linalg.det(d1))
print("x[0] =", complex(x[0]))
print("det =", det, "oracle =", np.linalg.det(d1))
print("complex matrix market OK")
