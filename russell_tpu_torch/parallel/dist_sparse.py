"""Row-partitioned sparse mat-vec over the ranks.

Counterpart of ``russell_tpu.parallel.dist_sparse``: the matrix's rows are
cut into equal padded slabs, one per rank, and each rank holds the
matching segment of x and of y. To multiply, the ranks all-gather x's
segments and each sums its slab's products per row in a fixed order
(``splu.segment_sum``), so the card gives the same bits on every run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse.ordering import segment_index
from russell_tpu_torch.sparse.splu import segment_sum

__all__ = ["ShardedCsr", "shard_csr_rows", "dist_mat_vec_mul"]


@dataclass(frozen=True)
class ShardedCsr:
    """Host-planned row partition of a CSR matrix (numpy arrays).

    The leading axis of every array is the shard axis (length n_shards);
    each shard's entries are padded to one length, the pads pointing at
    local row ``rows_per_shard`` (a scratch row, dropped) with value 0.
    """

    n: int                   # logical dimension
    n_shards: int
    rows_per_shard: int      # padded rows per shard
    local_rows: np.ndarray   # (n_shards, nnz_pad) row index local to shard
    cols: np.ndarray         # (n_shards, nnz_pad) global col index
    vals: np.ndarray         # (n_shards, nnz_pad) entries (0 in padding)
    # each shard's slab on a device, uploaded at its first product there
    _slabs: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows_per_shard


def shard_csr_rows(csr, n_shards: int) -> ShardedCsr:
    """Partition a CsrMatrix (full storage) into equal padded row slabs,
    entries in CSR order within each."""
    if csr.sym.triangular():
        raise ValueError("shard_csr_rows requires full (non-triangular) storage")
    n = csr.nrow
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices)
    vals = csr.data.detach().cpu().numpy()
    rps = -(-n // n_shards)
    shard_of = rows // rps
    nnz_pad = max(int(np.max(np.bincount(shard_of, minlength=n_shards))), 1)
    lr = np.full((n_shards, nnz_pad), rps, dtype=np.int32)
    cc = np.zeros((n_shards, nnz_pad), dtype=np.int32)
    vv = np.zeros((n_shards, nnz_pad), dtype=vals.dtype)
    for s in range(n_shards):
        m = shard_of == s
        k = int(np.sum(m))
        lr[s, :k] = rows[m] - s * rps
        cc[s, :k] = cols[m]
        vv[s, :k] = vals[m]
    return ShardedCsr(n=n, n_shards=n_shards, rows_per_shard=rps,
                      local_rows=lr, cols=cc, vals=vv)


def _slab(sh: ShardedCsr, s: int, device):
    key = (s, str(device))
    slab = sh._slabs.get(key)
    if slab is None:
        order, offsets = segment_index(sh.local_rows[s],
                                       sh.rows_per_shard + 1)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        slab = sh._slabs[key] = (
            t(sh.cols[s].astype(np.int64)), t(sh.vals[s]),
            None if order is None else t(order), t(offsets))
    return slab


def dist_mat_vec_mul(mesh, sh: ShardedCsr, x, axis: str = "rows"):
    """This rank's segment of y = A x: ``x`` is this rank's segment
    (``sh.rows_per_shard`` values, zeros past row n in the last one) and
    the result is the same rows of y. The segments are all-gathered over
    ``mesh``'s ``axis``, whose ranks must be ``sh.n_shards``."""
    ax = MeshAxis(mesh, axis)
    if ax.world != sh.n_shards:
        raise ValueError(f"{sh.n_shards} row slabs over {ax.world} ranks")
    x = torch.as_tensor(x, device=ax.device)
    rps = sh.rows_per_shard
    if tuple(x.shape) != (rps,):
        raise ValueError(f"x segment must have shape ({rps},), got "
                         f"{tuple(x.shape)}")
    cols, vals, order, offsets = _slab(sh, ax.rank, x.device)
    xfull = ax.gather(x)
    return segment_sum(vals * xfull[cols], order, offsets)[:rps]
