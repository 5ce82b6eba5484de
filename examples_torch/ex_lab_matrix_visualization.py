"""Sparsity visualization: export a matrix to the vismatrix .smat format
and to MatrixMarket .mtx (mirrors russell_lab
examples/matrix_visualization.rs and russell_sparse vismatrix flow).

Usage: python examples_torch/ex_lab_matrix_visualization.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np

from russell_tpu_torch.sparse import (read_matrix_market, samples,
                                      write_matrix_market)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

coo, _, _, _ = samples.umfpack_unsymmetric_5x5(device)
with tempfile.TemporaryDirectory() as tmp:
    smat = os.path.join(tmp, "matrix.smat")
    mtx = os.path.join(tmp, "matrix.mtx")
    write_matrix_market(coo, smat)          # vismatrix format by extension
    write_matrix_market(coo, mtx)
    print("--- vismatrix .smat ---")
    with open(smat) as fh:
        print(fh.read().strip())
    back, _ = read_matrix_market(mtx)
    assert np.allclose(np.asarray(back.as_dense()),
                       np.asarray(coo.as_dense()))
    print("round-trip through .mtx: exact")
print("ok")
