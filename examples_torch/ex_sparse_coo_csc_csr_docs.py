"""Sparse format doc-example tour: COO new/put/reset, CSC/CSR from
arrays and from COO with duplicate summation (mirrors russell_sparse/
examples/doc_coo_new_put_reset.rs, doc_coo_from_arrays.rs,
doc_csc_from_arrays.rs, doc_csc_from_coo.rs, doc_csr_from_arrays.rs,
doc_csr_from_coo.rs).

Usage: python examples_torch/ex_sparse_coo_csc_csr_docs.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import CooMatrix, CscMatrix, CsrMatrix

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# doc_coo_new_put_reset: capacity + put (duplicates allowed) + reset
coo = CooMatrix(3, 3, max_nnz=10)
coo.put(0, 0, 1.0)
coo.put(0, 0, 1.0)      # duplicate: summed on conversion
coo.put(1, 0, 3.0)
coo.put(0, 1, 3.0)
coo.put(1, 1, 2.0)
coo.put(2, 2, 4.0)
dense = np.asarray(coo.as_dense())
assert dense[0, 0] == 2.0 and dense[2, 2] == 4.0
coo.reset()
assert coo.nnz == 0

# doc_coo_from_arrays + conversions with duplicate summation
ii = np.asarray([0, 0, 1, 0, 1, 2])
jj = np.asarray([0, 0, 0, 1, 1, 2])
vv = np.asarray([1.0, 1.0, 3.0, 3.0, 2.0, 4.0])
coo2 = CooMatrix.from_arrays(3, 3, ii, jj, vv)
csc = CscMatrix.from_coo(coo2, device=device)
csr = CsrMatrix.from_coo(coo2, device=device)
ref = np.asarray([[2.0, 3.0, 0.0], [3.0, 2.0, 0.0], [0.0, 0.0, 4.0]])
assert np.allclose(csc.to_dense(), ref)
assert np.allclose(csr.to_dense(), ref)
assert csc.nnz == 5 and csr.nnz == 5   # duplicates summed

# matvec through each format
x = np.asarray([1.0, 2.0, 3.0])
for m in (coo2, csc, csr):
    y = m.mat_vec_mul(x)
    y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
    assert np.allclose(y, ref @ x)
print("dense:\n", ref)
print("coo/csc/csr doc tour OK")
