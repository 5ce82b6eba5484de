"""Sparse formats tour: COO put/reset, CSC/CSR conversion with duplicate
summing, and Matrix Market round trip (mirrors russell_sparse
examples/doc_coo_new_put_reset.rs, doc_csc_from_coo.rs,
doc_csr_from_coo.rs).

Usage: python examples_torch/ex_sparse_formats_tour.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np

from russell_tpu_torch.sparse import (CooMatrix, CscMatrix, CsrMatrix,
                                      read_matrix_market, write_matrix_market)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# the reference 5x5 doc sample, with a split (duplicated) entry
coo = CooMatrix(5, 5, 16)
coo.put(0, 0, 1.0)
coo.put(0, 0, 1.0)        # duplicate: sums to 2
coo.put(0, 1, 3.0)
coo.put(1, 0, 3.0)
coo.put(1, 2, 4.0)
coo.put(1, 4, 6.0)
coo.put(2, 1, -1.0)
coo.put(2, 2, -3.0)
coo.put(2, 3, 2.0)
coo.put(3, 2, 1.0)
coo.put(4, 1, 4.0)
coo.put(4, 2, 2.0)
coo.put(4, 4, 1.0)
dense = np.asarray(coo.as_dense())
print("dense[0] =", dense[0])
assert dense[0, 0] == 2.0      # duplicates summed

csc = CscMatrix.from_coo(coo, device=device)
csr = CsrMatrix.from_coo(coo, device=device)
assert np.allclose(csc.to_dense(), dense)
assert np.allclose(csr.to_dense(), dense)
print("CSC/CSR match COO after duplicate-summing conversion")

# matvec agreement
x = np.arange(1.0, 6.0)
assert np.allclose(np.asarray(coo.mat_vec_mul(x)), dense @ x)

# Matrix Market round trip
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "formats.mtx")
    write_matrix_market(coo, path)
    coo2, _ = read_matrix_market(path)
assert np.allclose(np.asarray(coo2.as_dense()), dense)
print("Matrix Market round trip verified")

# reset and refill
coo.reset()
coo.put(0, 0, 7.0)
assert np.asarray(coo.as_dense())[0, 0] == 7.0
print("reset/refill verified")
print("ok")
