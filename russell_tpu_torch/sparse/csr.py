"""CSR matrix: host structure, values as a tensor on a device.

Counterpart of ``russell_tpu.sparse.csr`` (reference contract:
russell_sparse/src/csr_matrix.rs — ``from_coo`` sums duplicate triplets,
csr_matrix.rs:332; ``mat_vec_mul`` honors triangular symmetric storage).

The *structure* (indptr/indices and the helper index arrays) is host numpy,
built once; the *values* are a tensor on the device the products run on.
For a frozen structure, new values come from new COO values through the
(perm, seg) map recorded by ``from_coo`` (``values_from_coo``), on the
device. The products are gather + ``index_add_`` on the values' device.
"""

from __future__ import annotations

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.sparse.enums import Sym

__all__ = ["CsrMatrix", "device_index"]


def device_index(owner, name: str, device) -> torch.Tensor:
    """The host index array ``owner.<name>`` as an int64 tensor on
    ``device``, uploaded once per (owner, device) and kept on ``owner``."""
    cache = owner.__dict__.setdefault("_device_cache", {})
    key = (name, str(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(
            np.asarray(getattr(owner, name), dtype=np.int64), device=device)
    return t


def _segment_sum(vals, seg, n):
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


class CsrMatrix:
    """Compressed-sparse-row matrix; ``data`` is a 1-D tensor of values on
    the device the products run on."""

    def __init__(self, nrow, ncol, indptr, indices, data: torch.Tensor,
                 sym: Sym = Sym.NO, row_ids=None, coo_perm=None,
                 coo_seg=None, coo_nnz=None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("data must be a tensor (on the device the "
                            "products run on); from_coo and from_dense "
                            "take a device")
        self.nrow = int(nrow)
        self.ncol = int(ncol)
        self.indptr = np.asarray(indptr, dtype=np.int32)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = data
        self.sym = sym
        if row_ids is None:
            row_ids = np.repeat(
                np.arange(self.nrow, dtype=np.int32), np.diff(self.indptr)
            )
        self.row_ids = np.asarray(row_ids, dtype=np.int32)
        # optional COO->CSR value map (set by from_coo)
        self.coo_perm = coo_perm
        self.coo_seg = coo_seg
        self.coo_nnz = coo_nnz

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_coo(cls, coo, device="cuda") -> "CsrMatrix":
        """Build CSR from a CooMatrix, summing duplicates (csr_matrix.rs:332),
        with the values on ``device``.

        Also records the (perm, seg) map so future value arrays laid out in
        the same COO order can be converted on the device (values_from_coo).
        """
        dev = russell_tpu_torch.device(device)
        ii, jj, vv = coo.triplets()
        order = np.lexsort((jj, ii))
        si, sj = ii[order], jj[order]
        # unique structural positions
        newgrp = np.ones(len(si), dtype=bool)
        if len(si) > 1:
            newgrp[1:] = (si[1:] != si[:-1]) | (sj[1:] != sj[:-1])
        seg = np.cumsum(newgrp) - 1
        nnz = int(seg[-1]) + 1 if len(seg) else 0
        ui = si[newgrp]
        uj = sj[newgrp]
        counts = np.bincount(ui, minlength=coo.nrow)
        indptr = np.zeros(coo.nrow + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        data = np.zeros(nnz, dtype=coo.dtype)
        np.add.at(data, seg, vv[order])
        return cls(coo.nrow, coo.ncol, indptr, uj,
                   torch.as_tensor(data, device=dev), coo.sym,
                   coo_perm=order.astype(np.int32),
                   coo_seg=seg.astype(np.int32), coo_nnz=len(si))

    @classmethod
    def from_dense(cls, a, sym: Sym = Sym.NO, device="cuda"):
        from russell_tpu_torch.sparse.coo import CooMatrix

        return cls.from_coo(CooMatrix.from_dense(np.asarray(a), sym), device)

    def values_from_coo(self, coo_values) -> torch.Tensor:
        """Map a COO-ordered value array onto this structure, on the
        device of ``data``.

        ``coo_values`` must follow the same triplet order used by from_coo.
        Duplicates are summed (``index_add_`` on the device).
        """
        if self.coo_perm is None:
            raise ValueError("this CSR was not built via from_coo")
        dev = self.data.device
        vals = torch.as_tensor(coo_values, device=dev)
        return _segment_sum(vals[device_index(self, "coo_perm", dev)],
                            device_index(self, "coo_seg", dev),
                            len(self.indices))

    def with_values(self, data) -> "CsrMatrix":
        """Same structure (and its uploaded index arrays), new values."""
        out = CsrMatrix(self.nrow, self.ncol, self.indptr, self.indices, data,
                        self.sym, row_ids=self.row_ids, coo_perm=self.coo_perm,
                        coo_seg=self.coo_seg, coo_nnz=self.coo_nnz)
        out._device_cache = self.__dict__.setdefault("_device_cache", {})
        return out

    # -- linear algebra --------------------------------------------------------

    def mat_vec_mul(self, u) -> torch.Tensor:
        """v = A @ u on the device of ``data`` (gather + ``index_add_``;
        mirrors csr_matrix.rs:735).

        Triangular symmetric storage adds the transposed off-diagonal part.
        """
        dev = self.data.device
        u = torch.as_tensor(u, device=dev)
        rows = device_index(self, "row_ids", dev)
        cols = device_index(self, "indices", dev)
        v = _segment_sum(self.data * u[cols], rows, self.nrow)
        if self.sym.triangular():
            off = rows != cols
            vals_t = self.data * u[rows]
            v = v + _segment_sum(torch.where(off, vals_t, 0.0 * vals_t), cols,
                                 self.nrow)
        return v

    def mat_t_vec_mul(self, u) -> torch.Tensor:
        dev = self.data.device
        u = torch.as_tensor(u, device=dev)
        rows = device_index(self, "row_ids", dev)
        cols = device_index(self, "indices", dev)
        v = _segment_sum(self.data * u[rows], cols, self.ncol)
        if self.sym.triangular():
            off = rows != cols
            vals_t = self.data * u[cols]
            v = v + _segment_sum(torch.where(off, vals_t, 0.0 * vals_t), rows,
                                 self.nrow)
        return v

    def to_dense(self) -> np.ndarray:
        d = self.data.detach().cpu().numpy()
        a = np.zeros((self.nrow, self.ncol), dtype=d.dtype)
        a[self.row_ids, self.indices] = d
        if self.sym.triangular():
            off = self.row_ids != self.indices
            a[self.indices[off], self.row_ids[off]] = d[off]
        return a

    # -- info -------------------------------------------------------------------

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def get_info(self):
        return self.nrow, self.ncol, self.nnz, self.sym

    def __repr__(self) -> str:
        return (f"CsrMatrix(nrow={self.nrow}, ncol={self.ncol}, nnz={self.nnz}, "
                f"sym={self.sym.name}, dtype={self.data.dtype})")
