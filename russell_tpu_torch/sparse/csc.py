"""CSC matrix: host structure, values as a tensor on a device.

Counterpart of ``russell_tpu.sparse.csc`` (reference:
russell_sparse/src/csc_matrix.rs). Same design as CsrMatrix: host structure,
values on a device, duplicate-summing ``from_coo`` (csc_matrix.rs:337).
"""

from __future__ import annotations

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.sparse.csr import _segment_sum, device_index
from russell_tpu_torch.sparse.enums import Sym

__all__ = ["CscMatrix"]


class CscMatrix:
    """Compressed-sparse-column matrix; ``data`` is a 1-D tensor of values
    on the device the products run on."""

    def __init__(self, nrow, ncol, indptr, indices, data: torch.Tensor,
                 sym: Sym = Sym.NO, col_ids=None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("data must be a tensor (on the device the "
                            "products run on); from_coo takes a device")
        self.nrow = int(nrow)
        self.ncol = int(ncol)
        self.indptr = np.asarray(indptr, dtype=np.int32)   # len ncol+1
        self.indices = np.asarray(indices, dtype=np.int32)  # row indices
        self.data = data
        self.sym = sym
        if col_ids is None:
            col_ids = np.repeat(
                np.arange(self.ncol, dtype=np.int32), np.diff(self.indptr)
            )
        self.col_ids = np.asarray(col_ids, dtype=np.int32)

    @classmethod
    def from_coo(cls, coo, device="cuda") -> "CscMatrix":
        dev = russell_tpu_torch.device(device)
        ii, jj, vv = coo.triplets()
        order = np.lexsort((ii, jj))
        si, sj = ii[order], jj[order]
        newgrp = np.ones(len(si), dtype=bool)
        if len(si) > 1:
            newgrp[1:] = (si[1:] != si[:-1]) | (sj[1:] != sj[:-1])
        seg = np.cumsum(newgrp) - 1
        nnz = int(seg[-1]) + 1 if len(seg) else 0
        ui = si[newgrp]
        uj = sj[newgrp]
        counts = np.bincount(uj, minlength=coo.ncol)
        indptr = np.zeros(coo.ncol + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        data = np.zeros(nnz, dtype=coo.dtype)
        np.add.at(data, seg, vv[order])
        return cls(coo.nrow, coo.ncol, indptr, ui,
                   torch.as_tensor(data, device=dev), coo.sym)

    @classmethod
    def from_csr(cls, csr) -> "CscMatrix":
        """The same matrix as ``csr``, values on the device of ``csr.data``."""
        order = np.lexsort((csr.row_ids, csr.indices))
        counts = np.bincount(csr.indices, minlength=csr.ncol)
        indptr = np.zeros(csr.ncol + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        perm = torch.as_tensor(order, device=csr.data.device)
        return cls(csr.nrow, csr.ncol, indptr, csr.row_ids[order],
                   csr.data[perm], csr.sym)

    def mat_vec_mul(self, u) -> torch.Tensor:
        """v = A @ u on the device of ``data`` (csc_matrix.rs:735 analog)."""
        dev = self.data.device
        u = torch.as_tensor(u, device=dev)
        rows = device_index(self, "indices", dev)
        cols = device_index(self, "col_ids", dev)
        v = _segment_sum(self.data * u[cols], rows, self.nrow)
        if self.sym.triangular():
            off = rows != cols
            vals_t = self.data * u[rows]
            v = v + _segment_sum(torch.where(off, vals_t, 0.0 * vals_t), cols,
                                 self.nrow)
        return v

    def to_dense(self) -> np.ndarray:
        d = self.data.detach().cpu().numpy()
        a = np.zeros((self.nrow, self.ncol), dtype=d.dtype)
        a[self.indices, self.col_ids] = d
        if self.sym.triangular():
            off = self.indices != self.col_ids
            a[self.col_ids[off], self.indices[off]] = d[off]
        return a

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def get_info(self):
        return self.nrow, self.ncol, self.nnz, self.sym

    def __repr__(self) -> str:
        return (f"CscMatrix(nrow={self.nrow}, ncol={self.ncol}, nnz={self.nnz}, "
                f"sym={self.sym.name}, dtype={self.data.dtype})")
