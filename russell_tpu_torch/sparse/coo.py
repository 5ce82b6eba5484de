"""COO (triplet) sparse matrix assembly.

Reference contract: russell_sparse/src/coo_matrix.rs (NumCooMatrix):
- fixed capacity ``max_nnz``; ``put`` appends triplets, duplicates allowed and
  summed on conversion (FEM assembly; lib.rs:23, csc_matrix.rs:337)
- a ``Sym`` flag records triangular storage for symmetric matrices

The construction part of ``russell_tpu.sparse.coo.CooMatrix``: what a
``System``'s mass matrix needs (Radau5 reads its triplets). Products,
``assign``/``add`` and dense conversion come with the solver surface
(ROADMAP.md). Host-side numpy by design: assembly is sequential.
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.sparse.enums import Sym

__all__ = ["CooMatrix"]


class CooMatrix:
    """Triplet matrix with russell-compatible semantics (dtype float64 or
    complex128)."""

    def __init__(self, nrow: int, ncol: int, max_nnz: int, sym: Sym = Sym.NO,
                 dtype=np.float64):
        if nrow < 1 or ncol < 1:
            raise ValueError("nrow and ncol must be >= 1")
        if max_nnz < 1:
            raise ValueError("max_nnz must be >= 1")
        if sym.triangular() and nrow != ncol:
            raise ValueError("symmetric matrices must be square")
        self.nrow = int(nrow)
        self.ncol = int(ncol)
        self.max_nnz = int(max_nnz)
        self.sym = sym
        self.dtype = np.dtype(dtype)
        self.nnz = 0
        self.indices_i = np.zeros(max_nnz, dtype=np.int64)
        self.indices_j = np.zeros(max_nnz, dtype=np.int64)
        self.values = np.zeros(max_nnz, dtype=self.dtype)

    # -- construction -------------------------------------------------------

    def put(self, i: int, j: int, value) -> None:
        """Append a triplet (duplicates allowed; coo_matrix.rs:324)."""
        if not (0 <= i < self.nrow):
            raise ValueError("index i is out of range")
        if not (0 <= j < self.ncol):
            raise ValueError("index j is out of range")
        if self.sym == Sym.YES_LOWER and j > i:
            raise ValueError("j > i is incorrect for lower triangular storage")
        if self.sym == Sym.YES_UPPER and j < i:
            raise ValueError("j < i is incorrect for upper triangular storage")
        if self.nnz >= self.max_nnz:
            raise ValueError("max number of items has been reached")
        self.indices_i[self.nnz] = i
        self.indices_j[self.nnz] = j
        self.values[self.nnz] = value
        self.nnz += 1

    # -- getters -------------------------------------------------------------

    def triplets(self):
        """(i, j, v) views of the active triplets."""
        return (
            self.indices_i[: self.nnz],
            self.indices_j[: self.nnz],
            self.values[: self.nnz],
        )

    def __repr__(self) -> str:
        return (
            f"CooMatrix(nrow={self.nrow}, ncol={self.ncol}, nnz={self.nnz}, "
            f"sym={self.sym.name}, dtype={self.dtype})"
        )
