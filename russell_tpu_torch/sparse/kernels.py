"""Sparse products on the card: BSR SpMV / SpMM, plus block SpGEMM.

Counterpart of ``russell_tpu.sparse.kernels``. The matrix is converted once
on the host to **block-sparse rows (BSR)** with uniform (bm, bn) blocks and
uploaded; each block row is padded to ``blocks_per_row`` slots whose pads
carry block-column id 0, a zero block and mask 0. SpGEMM keeps the
symbolic/numeric split: the host plans the block products, sorted by
destination, and the numeric phase runs on the device.

Each product has a hand-written CUDA kernel (``csrc/bsr_spmv.cu``,
``csrc/bsr_spmm.cu``, ``csrc/spgemm_blocks.cu``) and a plain PyTorch
version beside it (the reference's einsum / scatter-add paths). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no switch and no fallback. Each wrapper counts its
launches (``bsr_matvec.launches``, ``bsr_matmat.launches``,
``spgemm.launches``; ``reset_launch_counts``). The kernels take float64
and complex128 (``KERNEL_DTYPES``, one C entry point each); float32 is
refused on the card: the port computes in f64 throughout, and the
reference's float32 exists for the TPU.

No kernel walks the blocks: a banded matrix in 8x128 (or 16x16) blocks
stores about 99 % zeros. SpMV and SpMM read a ``LiveLayout`` of the
matrix's nonzero entries (sliced ELLPACK, 32 rows a slice), derived from
``blocks * mask`` by ``_live_layout``; SpGEMM reads a ``RowLayout`` (CSR
of the entries its reference multiplies), derived by ``_spgemm_layout``.
Each is built once per matrix on its device and cached on the
``BsrMatrix``; the blocks stay as stored for the plain versions and
``interop``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.sparse import _cuda

__all__ = ["BsrMatrix", "bsr_from_coo", "bsr_from_arrays", "bsr_matvec",
           "bsr_matmat", "SpgemmPlan", "spgemm_plan", "spgemm",
           "reset_launch_counts"]

SLICE_ROWS = 32         # rows of a LiveLayout slice: one warp, a lane a row
# block-entries of the blocks held at once while a layout is derived
_LAYOUT_CHUNK = 1 << 26
# shared memory one spgemm_blocks CTA gives its strip of C (whole blocks of
# one block row; a block row of more is walked in chunks): 64 KB holds the
# 29 16x16 C blocks of a Brusselator block row, three CTAs an SM
SPGEMM_STRIP_BYTES = 64 << 10
_SMEM_MAX = 232448      # shared memory one CTA can have on an H100
# the value types of the BSR kernels, each with its C entry point's suffix
KERNEL_DTYPES = {torch.float64: "f64", torch.complex128: "c128"}


@dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse-row matrix with uniform (bm x bn) blocks on one device.

    blocks[k] is the k-th stored block; rows are padded to ``blocks_per_row``
    with index 0 + mask 0 (slot 0 is a real block; masking handles reuse).
    """

    n_rows: int
    n_cols: int
    bm: int
    bn: int
    nbr: int                     # number of block rows
    blocks_per_row: int          # padded count
    blocks: torch.Tensor         # (nbr * blocks_per_row, bm, bn)
    col_ids: torch.Tensor        # (nbr, blocks_per_row) int32 block-col index
    mask: torch.Tensor           # (nbr, blocks_per_row) 1.0 valid, 0.0 pad

    @property
    def n_rows_pad(self) -> int:
        return self.nbr * self.bm

    @property
    def n_cols_pad(self) -> int:
        return int(self.col_ids.max() + 1) * self.bn if self.col_ids.numel() \
            else self.bn


def bsr_from_arrays(n_rows, n_cols, bm, bn, blocks, col_ids, mask,
                    device="cuda") -> BsrMatrix:
    """A ``BsrMatrix`` on ``device`` from host arrays (one upload each),
    after checking that they describe one: shapes, and every block-column
    id inside the ``ceil(n_cols / bn)`` panels of x, which the kernels rely
    on."""
    dev = russell_tpu_torch.device(device)
    blocks = np.asarray(blocks)
    col_ids = np.asarray(col_ids)
    mask = np.asarray(mask)
    nbr = -(-int(n_rows) // bm)
    nbc = -(-int(n_cols) // bn)
    if col_ids.ndim != 2 or col_ids.shape[0] != nbr or col_ids.shape[1] < 1:
        raise ValueError(f"col_ids must be (ceil(n_rows / bm), bpr >= 1) = "
                         f"({nbr}, ·), got {col_ids.shape}")
    bpr = col_ids.shape[1]
    if mask.shape != col_ids.shape or blocks.shape != (nbr * bpr, bm, bn):
        raise ValueError("blocks must be (nbr * bpr, bm, bn) and mask "
                         "(nbr, bpr)")
    if int(col_ids.min()) < 0 or int(col_ids.max()) >= nbc:
        raise ValueError(f"block-column ids leave [0, {nbc})")
    return BsrMatrix(
        int(n_rows), int(n_cols), bm, bn, nbr, bpr,
        torch.as_tensor(np.ascontiguousarray(blocks), device=dev),
        torch.as_tensor(np.ascontiguousarray(col_ids, dtype=np.int32),
                        device=dev),
        torch.as_tensor(np.ascontiguousarray(mask, dtype=blocks.dtype),
                        device=dev))


def bsr_from_coo(coo, bm: int = 8, bn: int = 128,
                 device="cuda") -> BsrMatrix:
    """Host conversion COO -> BSR with duplicate summation, then one upload
    to ``device``.

    Fully vectorized (sort + unique + scatter-add); no per-entry Python
    loop, so conversion stays O(nnz log nnz) C time at the matrix sizes
    the baseline targets (10^5..10^6 rows)."""
    if coo.sym.triangular():
        raise ValueError("bsr_from_coo requires full (non-triangular) "
                         "storage")
    dev = russell_tpu_torch.device(device)
    ii, jj, vv = coo.triplets()
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    vv = np.asarray(vv)
    nbr = -(-coo.nrow // bm)
    nbc = -(-coo.ncol // bn)
    bi = (ii // bm).astype(np.int64)
    bj = (jj // bn).astype(np.int64)
    key = bi * nbc + bj
    ukeys, inv = np.unique(key, return_inverse=True)
    ubi = ukeys // nbc                            # sorted by (bi, bj)
    counts = np.bincount(ubi, minlength=nbr)
    bpr = max(int(counts.max()) if len(ukeys) else 0, 1)
    row_start = np.searchsorted(ubi, np.arange(nbr))
    slot = np.arange(len(ukeys)) - row_start[ubi]  # rank within block row
    storage = ubi * bpr + slot                     # storage id per unique
    blocks = np.zeros((nbr * bpr, bm, bn), dtype=vv.dtype)
    np.add.at(blocks, (storage[inv], ii - bi * bm, jj - bj * bn), vv)
    col_ids = np.zeros((nbr, bpr), dtype=np.int32)
    mask = np.zeros((nbr, bpr), dtype=vv.dtype)
    col_ids.reshape(-1)[storage] = (ukeys % nbc).astype(np.int32)
    mask.reshape(-1)[storage] = 1.0
    return bsr_from_arrays(coo.nrow, coo.ncol, bm, bn, blocks, col_ids, mask,
                           dev)


def _pad_x(bsr: BsrMatrix, x):
    """x (n_cols[, m]) zero-padded to whole bn panels (plain versions)."""
    ncp = (int(bsr.col_ids.max()) + 1) * bsr.bn
    ncp = max(ncp, -(-bsr.n_cols // bsr.bn) * bsr.bn)
    xp = torch.zeros((ncp,) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    xp[: bsr.n_cols] = x
    return xp


def _operand(name, bsr: BsrMatrix, x, ndim):
    """``x`` as a contiguous tensor of the blocks' dtype on their device,
    of shape (n_cols,) or (n_cols, m)."""
    x = torch.as_tensor(x, dtype=bsr.blocks.dtype,
                        device=bsr.blocks.device).contiguous()
    if x.dim() != ndim or x.shape[0] != bsr.n_cols:
        want = "(n_cols,)" if ndim == 1 else "(n_cols, m)"
        raise ValueError(f"{name}: x must be {want} with n_cols = "
                         f"{bsr.n_cols}, got {tuple(x.shape)}")
    return x


# ---------------------------------------------------------------------------
# The live-entry layouts the kernels read
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LiveLayout:
    """The nonzero entries of a ``BsrMatrix``'s ``blocks * mask`` with row
    < n_rows and column < n_cols, as sliced ELLPACK of SLICE_ROWS rows a
    slice (SELL-32).

    Slice s holds rows 32 s .. 32 s + 31 and is as wide as its longest row;
    entry k of row 32 s + l lies at ``slice_off[s] + 32 k + l`` of ``val``
    and ``col``, so the 32 lanes of a warp read one entry of 32 rows from
    consecutive addresses. A row's entries come in column order; its slots
    past its length hold value 0 and the row's last column (column 0 for
    an empty row), so a pad never reads x out of bounds."""

    n_rows: int
    n_cols: int
    nnz: int                   # live entries, the same in any layout
    slice_off: torch.Tensor    # (n_slices + 1,) int64
    val: torch.Tensor          # (slice_off[-1],) the blocks' dtype
    col: torch.Tensor          # (slice_off[-1],) int32 global column

    @property
    def n_slices(self) -> int:
        return self.slice_off.numel() - 1

    @property
    def pad_share(self) -> float:
        """Share of the slots that are pads."""
        slots = self.val.numel()
        return 1.0 - self.nnz / slots if slots else 0.0

    @property
    def tensors(self):
        return self.slice_off, self.val, self.col

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)


@dataclass(frozen=True)
class RowLayout:
    """The entries SpGEMM multiplies, as CSR: the nonzero entries of the
    stored blocks of every slot with mask > 0, unscaled, over every row of
    every block row (``nbr * bm`` rows) and the blocks' full width.

    Row r's entries are ``row_ptr[r] .. row_ptr[r + 1]`` of ``col`` and
    ``val``, in column order; a position held by several slots (duplicated
    block columns) has one entry per slot, side by side in slot order."""

    n_rows: int                # nbr * bm
    nnz: int
    row_ptr: torch.Tensor      # (n_rows + 1,) int64
    col: torch.Tensor          # (nnz,) int32 global column
    val: torch.Tensor          # (nnz,) the blocks' dtype

    @property
    def tensors(self):
        return self.row_ptr, self.val, self.col

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)


def _live_entries(bsr: BsrMatrix, spgemm: bool = False):
    """(row, col, val) of the nonzero entries of ``blocks * mask`` with row
    < n_rows and column < n_cols (x is zero past n_cols in the reference);
    with ``spgemm``, of the unscaled blocks of the slots with mask > 0, all
    rows and columns of each block (the reference's SpGEMM terms). Sorted
    by (row, column) — stably, so entries of one position held by several
    slots keep their slot order. Torch ops on the blocks' device, over the
    live slots only, ``_LAYOUT_CHUNK`` block entries at a time."""
    bm, bn, bpr = bsr.bm, bsr.bn, bsr.blocks_per_row
    dev = bsr.blocks.device
    weight = bsr.mask.reshape(-1)
    block_col = bsr.col_ids.reshape(-1)
    # a complex matrix's mask is complex (bsr_from_coo keeps the COO's
    # dtype); SpGEMM's "mask > 0" reads its real part, as numpy orders
    # complex values in the plan
    live = (weight.real if weight.is_complex() else weight) > 0
    slots = torch.nonzero(live if spgemm else weight).reshape(-1)
    step = max(1, _LAYOUT_CHUNK // max(bm * bn, 1))
    rows, cols, vals = [], [], []
    for s0 in range(0, slots.numel(), step):
        sl = slots[s0:s0 + step]
        blk = bsr.blocks.index_select(0, sl)
        if not spgemm:
            blk.mul_(weight[sl].view(-1, 1, 1))
        k, i, j = torch.nonzero(blk, as_tuple=True)
        vals.append(blk[k, i, j])
        slot = sl[k]
        rows.append(torch.div(slot, bpr, rounding_mode="floor") * bm + i)
        cols.append(block_col[slot].long() * bn + j)
    if not rows:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, torch.zeros(0, dtype=bsr.blocks.dtype,
                                         device=dev)
    row, col, val = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    if spgemm:
        width = bsr.n_cols_pad
    else:
        keep = (row < bsr.n_rows) & (col < bsr.n_cols)
        row, col, val = row[keep], col[keep], val[keep]
        width = bsr.n_cols
    order = torch.sort(row * width + col, stable=True).indices
    return row[order], col[order], val[order]


def _sell_layout(n_rows, n_cols, row, col, val) -> LiveLayout:
    """SELL-32 of the entries (row, col, val), sorted by (row, column)."""
    dev = val.device
    i64 = dict(dtype=torch.int64, device=dev)
    n_slices = -(-n_rows // SLICE_ROWS)
    n_lanes = n_slices * SLICE_ROWS             # rows, the ragged slice padded
    row_len = torch.bincount(row, minlength=n_lanes)
    width = row_len.view(n_slices, SLICE_ROWS).amax(dim=1) if n_slices \
        else torch.zeros(0, **i64)
    slice_off = torch.zeros(n_slices + 1, **i64)
    slice_off[1:] = torch.cumsum(width * SLICE_ROWS, 0)
    n_slots = int(slice_off[-1])
    row_start = torch.cumsum(row_len, 0) - row_len
    # a pad takes its row's last column; an empty row's pads column 0
    last = torch.zeros(n_lanes, **i64)
    has = row_len > 0
    last[has] = col[(row_start + row_len - 1)[has]]
    slot_slice = torch.repeat_interleave(
        torch.arange(n_slices, **i64), width * SLICE_ROWS,
        output_size=n_slots)
    lane = (torch.arange(n_slots, **i64) - slice_off[slot_slice]) \
        % SLICE_ROWS
    c = last[slot_slice * SLICE_ROWS + lane].to(torch.int32)
    v = torch.zeros(n_slots, dtype=val.dtype, device=dev)
    k = torch.arange(row.numel(), **i64) - row_start[row]
    pos = slice_off[torch.div(row, SLICE_ROWS, rounding_mode="floor")] \
        + k * SLICE_ROWS + row % SLICE_ROWS
    c[pos] = col.to(torch.int32)
    v[pos] = val
    return LiveLayout(int(n_rows), int(n_cols), int(row.numel()), slice_off,
                      v, c)


def _csr_layout(n_rows, row, col, val) -> RowLayout:
    """CSR of the entries (row, col, val), sorted by (row, column)."""
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=val.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(row, minlength=n_rows), 0)
    return RowLayout(int(n_rows), int(row.numel()), row_ptr,
                     col.to(torch.int32), val)


# Each cached layout: the attribute it is kept under on the BsrMatrix, and
# how it is built. SpGEMM gets its own: the reference multiplies the stored
# blocks of every slot with mask > 0, unscaled, over their padded extent,
# where SpMV / SpMM take blocks * mask cut to n_rows x n_cols. The two
# agree on every matrix bsr_from_coo builds (0/1 mask, zeros in the
# padding), not on one from bsr_from_arrays with a mask of 0.5, values
# past n_rows / n_cols or in a mask-0 slot; so neither can stand in for
# the other. The RowLayout holds no operand-specific cut: A's entries past
# B's rows (block columns the plan drops) are skipped by the kernel, so
# one RowLayout serves a matrix as A and as B, and A·A builds it once.
_LAYOUTS = {
    "_live_layout": lambda bsr: _sell_layout(bsr.n_rows, bsr.n_cols,
                                             *_live_entries(bsr)),
    "_spgemm_layout": lambda bsr: _csr_layout(bsr.n_rows_pad,
                                              *_live_entries(bsr, True)),
}


def _layout_key(bsr: BsrMatrix):
    """What a cached layout of ``bsr`` is valid for: the storage and the
    version counter of ``blocks``, ``mask`` and ``col_ids``; None when one
    of them is an inference tensor, which has no version counter."""
    parts = (bsr.blocks, bsr.mask, bsr.col_ids)
    if any(t.is_inference() for t in parts):
        return None
    return tuple((t.data_ptr(), t._version) for t in parts)


def _layout_entry(bsr: BsrMatrix, name: str = "_live_layout"):
    """The cache entry of ``bsr``'s layout ``name`` (a key of _LAYOUTS):
    built on the blocks' device (on the current CUDA stream there) when the
    matrix has none or its key changed, and kept on the matrix unless the
    key is None, when it is built anew at each call. On CUDA the entry
    holds an event recorded after the build and the streams that have
    waited on it."""
    if bsr.n_rows_pad >= 2 ** 31 or -(-bsr.n_cols // bsr.bn) * bsr.bn \
            >= 2 ** 31:
        raise ValueError("the live layouts take fewer than 2^31 rows and "
                         "columns, padded to whole blocks (int32 columns)")
    key = _layout_key(bsr)
    entry = bsr.__dict__.get(name)
    if key is not None and entry is not None and entry["key"] == key:
        return entry
    entry = {"key": key, "layout": _LAYOUTS[name](bsr)}
    dev = bsr.blocks.device
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        entry["ready"] = torch.cuda.Event()
        entry["ready"].record(stream)
        entry["streams"] = {stream.cuda_stream}
    if key is not None:
        bsr.__dict__[name] = entry
    return entry


def _live_layout(bsr: BsrMatrix) -> LiveLayout:
    """The ``LiveLayout`` of ``bsr``, built on the blocks' device at its
    first use and kept on the matrix. The cache is keyed on the storage
    and the version counter of ``blocks``, ``mask`` and ``col_ids``, so an
    in-place torch op on any of them builds it anew; a write that leaves
    the version counter as it was (through ``.data``, DLPack or a raw
    pointer) is not seen. Inference tensors have no version counter: their
    layout is built at every call."""
    return _layout_entry(bsr)["layout"]


def _spgemm_layout(bsr: BsrMatrix) -> RowLayout:
    """The ``RowLayout`` of ``bsr`` that SpGEMM reads, built and kept as
    ``_live_layout``."""
    return _layout_entry(bsr, "_spgemm_layout")["layout"]


def _check_kernel_bsr(name, bsr: BsrMatrix):
    """What a BSR kernel takes: float64 or complex128 blocks on a CUDA
    device, col ids and mask on the same device. Returns the suffix of the
    kernel's C entry point for the blocks' dtype."""
    dev = bsr.blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    parts = (bsr.blocks, bsr.col_ids, bsr.mask)
    if any(t.device != dev for t in parts):
        raise ValueError(f"{name}: blocks, col_ids and mask must lie on "
                         f"{dev}")
    suffix = KERNEL_DTYPES.get(bsr.blocks.dtype)
    if suffix is None:
        raise TypeError(f"{name}: the kernel takes float64 or complex128 "
                        f"blocks, got {bsr.blocks.dtype}: float32 and the "
                        "other types are refused as intended (the port "
                        "computes in f64)")
    return suffix


def _kernel_layout(bsr: BsrMatrix, layout: str = "_live_layout"):
    """The layout ``layout`` of ``bsr`` that a kernel reads, ready for a
    launch on the current CUDA stream: a stream other than the one that
    built it waits, at its first launch, on the build's event and is
    recorded on the layout's tensors, so the allocator keeps them until
    that stream's work is done."""
    entry = _layout_entry(bsr, layout)
    lay = entry["layout"]
    stream = torch.cuda.current_stream(bsr.blocks.device)
    if stream.cuda_stream not in entry["streams"]:
        stream.wait_event(entry["ready"])
        for t in lay.tensors:
            t.record_stream(stream)
        entry["streams"].add(stream.cuda_stream)
    return lay


# ---------------------------------------------------------------------------
# SpMV / SpMM: wrappers and plain versions
# ---------------------------------------------------------------------------


def _bsr_matvec_plain(bsr: BsrMatrix, x):
    """Plain PyTorch version of ``bsr_matvec`` (kernels.py:178-183 of the
    reference package): gather the x panels, masked batched block products,
    sum over each block row's slots."""
    x2 = _pad_x(bsr, x).view(-1, bsr.bn)
    gathered = x2[bsr.col_ids.reshape(-1).long()]        # (nbr*bpr, bn)
    prods = torch.einsum("kij,kj->ki", bsr.blocks
                         * bsr.mask.reshape(-1, 1, 1), gathered)
    y = prods.reshape(bsr.nbr, bsr.blocks_per_row, bsr.bm).sum(dim=1)
    return y.reshape(-1)[: bsr.n_rows]


def bsr_matvec(bsr: BsrMatrix, x):
    """y = A x through the BSR blocks; x is (n_cols,), y (n_rows,) on the
    blocks' device.

    Replaces the reference package's ``_bsr_matvec_pallas``. A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/bsr_spmv.cu``
    over the matrix's ``LiveLayout`` or raises. The layout is built at the
    first call, which costs more than a product (about 14 products at the
    npoint-513 Brusselator Jacobian), and kept for later calls until an
    in-place torch op changes ``blocks``, ``mask`` or ``col_ids``. A write
    that bypasses torch's version counter (``.data``, DLPack, a raw
    pointer) is not seen: make a new ``BsrMatrix`` after one."""
    x = _operand("bsr_matvec", bsr, x, 1)
    if bsr.blocks.device.type == "cpu":
        return _bsr_matvec_plain(bsr, x)
    suffix = _check_kernel_bsr("bsr_matvec", bsr)
    lay = _kernel_layout(bsr)
    y = torch.empty(bsr.n_rows, dtype=x.dtype, device=x.device)
    if bsr.n_rows:
        fn = getattr(_cuda.library("bsr_spmv"), f"bsr_spmv_{suffix}")
        _cuda.launch_check("bsr_matvec", fn(
            lay.val.data_ptr(), lay.col.data_ptr(), lay.slice_off.data_ptr(),
            x.data_ptr(), bsr.n_rows, lay.n_slices, y.data_ptr(),
            _cuda.stream_of(x)))
        bsr_matvec.launches += 1
    return y


def _bsr_matmat_plain(bsr: BsrMatrix, X):
    """Plain PyTorch version of ``bsr_matmat`` (kernels.py:237-242 of the
    reference package)."""
    m = X.shape[1]
    X3 = _pad_x(bsr, X).view(-1, bsr.bn, m)
    gathered = X3[bsr.col_ids.reshape(-1).long()]       # (nbr*bpr, bn, m)
    prods = torch.einsum("kij,kjm->kim", bsr.blocks
                         * bsr.mask.reshape(-1, 1, 1), gathered)
    Y = prods.reshape(bsr.nbr, bsr.blocks_per_row, bsr.bm, m).sum(dim=1)
    return Y.reshape(-1, m)[: bsr.n_rows]


def bsr_matmat(bsr: BsrMatrix, X):
    """Y = A X for dense X (n_cols, m) — SpMM; Y is (n_rows, m) on the
    blocks' device.

    Replaces the reference package's ``_bsr_matmat_pallas``. A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/bsr_spmm.cu``
    over the matrix's ``LiveLayout`` (built and kept as in
    ``bsr_matvec``) or raises."""
    X = _operand("bsr_matmat", bsr, X, 2)
    if bsr.blocks.device.type == "cpu":
        return _bsr_matmat_plain(bsr, X)
    suffix = _check_kernel_bsr("bsr_matmat", bsr)
    lay = _kernel_layout(bsr)
    m = X.shape[1]
    Y = torch.empty((bsr.n_rows, m), dtype=X.dtype, device=X.device)
    if bsr.n_rows and m:
        fn = getattr(_cuda.library("bsr_spmm"), f"bsr_spmm_{suffix}")
        _cuda.launch_check("bsr_matmat", fn(
            lay.val.data_ptr(), lay.col.data_ptr(), lay.slice_off.data_ptr(),
            X.data_ptr(), bsr.n_rows, lay.n_slices, m, Y.data_ptr(),
            _cuda.stream_of(X)))
        bsr_matmat.launches += 1
    return Y


# ---------------------------------------------------------------------------
# SpGEMM: C = A B with host symbolic pattern + device block products
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpgemmPlan:
    n: int
    b: int
    a_idx: np.ndarray     # (n_ops,) index into A block storage
    b_idx: np.ndarray     # (n_ops,) index into B block storage
    c_idx: np.ndarray     # (n_ops,) destination C block (sorted)
    c_ptr: np.ndarray     # (c_blocks + 1,) op range of each C block
    c_blocks: int
    c_block_ij: np.ndarray  # (c_blocks, 2) block coordinates of C


def _c_ptr(c_idx, c_blocks):
    """Per C block, its op range ``c_ptr[c]:c_ptr[c+1]`` in the
    destination-sorted ops (a searchsorted, as SPLU's ``seg_ptr``)."""
    return np.searchsorted(c_idx, np.arange(c_blocks + 1)).astype(np.int64)


def spgemm_plan(a: BsrMatrix, b: BsrMatrix) -> SpgemmPlan:
    """Symbolic product pattern (host). Fully vectorized: ops are the
    expansion (A block, matching B block) via repeat/searchsorted; C
    blocks come from np.unique of the (i, j) keys, so ``c_block_ij`` is
    sorted by (block row, block column) and a block row's C blocks are
    contiguous in C. Ops are sorted by destination, and ``c_ptr`` gives
    each C block its op range (the plain version's products; the kernel
    reads the operands' live entries instead)."""
    if a.bn != b.bm:
        raise ValueError("inner block dims must agree")
    a_cols = a.col_ids.cpu().numpy()
    a_mask = a.mask.cpu().numpy()
    b_cols = b.col_ids.cpu().numpy()
    b_mask = b.mask.cpu().numpy()
    ai, as_ = np.nonzero((a_mask > 0) & (a_cols < b.nbr))
    k = a_cols[ai, as_].astype(np.int64)
    bk_idx, bt_idx = np.nonzero(b_mask > 0)       # sorted by B block row
    bcnt = np.bincount(bk_idx, minlength=b.nbr)
    bstart = np.concatenate([[0], np.cumsum(bcnt)])[:-1]
    rep = bcnt[k]
    n_ops = int(rep.sum())
    if n_ops:
        i_op = np.repeat(ai.astype(np.int64), rep)
        a_op = np.repeat(ai * a.blocks_per_row + as_, rep).astype(np.int64)
        offs = np.arange(n_ops) - np.repeat(np.cumsum(rep) - rep, rep)
        sel = np.repeat(bstart[k], rep) + offs
        b_op = (bk_idx[sel] * b.blocks_per_row + bt_idx[sel]).astype(
            np.int64)
        j_op = b_cols[bk_idx[sel], bt_idx[sel]].astype(np.int64)
        nbc_out = max(int(j_op.max()) + 1, 1)
        ckey = i_op * nbc_out + j_op
        ukeys, c_op = np.unique(ckey, return_inverse=True)
        order = np.argsort(c_op, kind="stable")   # stream by destination
        a_op, b_op, c_op = a_op[order], b_op[order], c_op[order]
        cij = np.stack([ukeys // nbc_out, ukeys % nbc_out], axis=1)
    else:
        a_op = b_op = c_op = np.zeros(0, dtype=np.int64)
        cij = np.zeros((1, 2), dtype=np.int64)
    c_blocks = max(cij.shape[0], 1)
    return SpgemmPlan(n=a.n_rows, b=a.bm, a_idx=a_op, b_idx=b_op,
                      c_idx=c_op, c_ptr=_c_ptr(c_op, c_blocks),
                      c_blocks=c_blocks, c_block_ij=cij)


def _upload(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _device_plan(plan: SpgemmPlan, device):
    """What the kernel reads of the plan, on ``device``: the C block-row
    pointer over ``c_block_ij[:, 0]`` (int64, ``nbr + 1``) and each C
    block's block column (int32), with the number of C block rows and the
    most C blocks of one. Uploaded once per (plan, device), kept on the
    plan, checked here once: the C blocks sorted by (i, j) without repeats,
    which makes each block row's C blocks one contiguous run of C."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    dp = cache.get(key)
    if dp is not None:
        return dp
    cij = np.asarray(plan.c_block_ij, dtype=np.int64)
    if cij.shape != (plan.c_blocks, 2) or int(cij.min()) < 0 \
            or int(cij[:, 1].max()) >= 2 ** 31:
        raise ValueError("spgemm: c_block_ij must be (c_blocks, 2) block "
                         "coordinates in [0, 2^31)")
    di, dj = np.diff(cij[:, 0]), np.diff(cij[:, 1])
    if ((di < 0) | ((di == 0) & (dj <= 0))).any():
        raise ValueError("spgemm: plan C blocks are not sorted by (i, j)")
    nbr = int(cij[-1, 0]) + 1
    row_ptr = np.searchsorted(cij[:, 0], np.arange(nbr + 1))
    dp = cache[key] = {
        "c_row_ptr": _upload(row_ptr, torch.int64, device),
        "c_col": _upload(cij[:, 1], torch.int32, device),
        "nbr": nbr,
        "max_row_blocks": int(np.diff(row_ptr).max()),
    }
    return dp


def _plan_ops(plan: SpgemmPlan, device):
    """The plan's block products on ``device`` (int64 indices) with the
    storage sizes they index, for the plain version only: checked (the
    destinations sorted, ``c_ptr`` matching them) and uploaded at its
    first call, and kept with ``_device_plan``'s arrays."""
    dp = _device_plan(plan, device)
    if "a_idx" in dp:
        return dp
    n_ops = len(plan.a_idx)
    c_idx = np.asarray(plan.c_idx)
    if n_ops and (int(c_idx.min()) < 0 or int(c_idx.max()) >= plan.c_blocks
                  or (np.diff(c_idx) < 0).any()):
        raise ValueError("spgemm: plan destinations are not sorted C blocks")
    if not np.array_equal(plan.c_ptr, _c_ptr(c_idx, plan.c_blocks)):
        raise ValueError("spgemm: plan c_ptr does not match c_idx")
    dp["a_need"] = int(np.max(plan.a_idx)) + 1 if n_ops else 0
    dp["b_need"] = int(np.max(plan.b_idx)) + 1 if n_ops else 0
    for name in ("a_idx", "b_idx", "c_idx"):
        dp[name] = _upload(getattr(plan, name), torch.int64, device)
    return dp


def _strip_chunks(bm, bn, max_blocks, budget=None, elem=8):
    """(rows, blocks) of the strip of C that one CTA of spgemm_blocks holds
    in shared memory, at ``elem`` bytes a value (8 float64, 16 complex128):
    as many whole C blocks of its block row as fit in ``budget`` bytes
    (SPGEMM_STRIP_BYTES; at most ``max_blocks``, at least one) with their
    int32 block columns; or, when one block does not fit, runs of rows of
    one block. A budget below one row of a block is raised to it. One row
    of a C block must fit the card's shared memory: bn <= 29,055 in
    float64 and 14,527 in complex128, a limit kept as intended (no BSR
    shape that a caller of either package builds comes near it)."""
    budget = SPGEMM_STRIP_BYTES if budget is None else budget
    row = elem * bn + 4
    if row > _SMEM_MAX:
        raise ValueError(f"spgemm: one row of a C block ({bn} values of "
                         f"{elem} bytes) exceeds the card's shared memory "
                         f"(bn <= {(_SMEM_MAX - 4) // elem}; a limit kept "
                         "as intended)")
    budget = max(budget, row)
    per_block = elem * bm * bn + 4
    if per_block <= budget:
        return bm, max(1, min(max_blocks, budget // per_block))
    return min(bm, (budget - 4) // (elem * bn)), 1


def _spgemm_plain(plan: SpgemmPlan, a: BsrMatrix, b: BsrMatrix):
    """Plain PyTorch version of ``spgemm`` (kernels.py:366-372 of the
    reference package): batched block products, scatter-added into C."""
    ops = _plan_ops(plan, a.blocks.device)
    if ops["a_need"] > a.blocks.shape[0] or ops["b_need"] > b.blocks.shape[0]:
        raise ValueError("spgemm: the plan indexes past the A or B block "
                         "storage (a plan of other matrices?)")
    A = a.blocks[ops["a_idx"]]
    B = b.blocks[ops["b_idx"]]
    C = torch.zeros((plan.c_blocks, a.bm, b.bn), dtype=a.blocks.dtype,
                    device=a.blocks.device)
    return C.index_add_(0, ops["c_idx"], torch.bmm(A, B))


def spgemm(plan: SpgemmPlan, a: BsrMatrix, b: BsrMatrix):
    """Numeric SpGEMM C = A B over the planned block products.

    Returns (C, c_block_ij): C (c_blocks, bm, bn) on the blocks' device and
    the block coordinates of each C block — a BSR-like block list.

    Replaces the reference package's ``_spgemm_pallas``. A CPU tensor takes
    the plain version; a CUDA tensor launches ``csrc/spgemm_blocks.cu`` or
    raises: each block row of C is summed from the products of A's and B's
    live entries (their ``RowLayout``s, built at the first call on each
    matrix and kept as ``bsr_matvec``'s layout is) into a strip in shared
    memory that is written to C once. float64 or complex128; any bm; a row
    of a C block up to the card's shared memory (bn <= 29,055 in float64,
    14,527 in complex128)."""
    if a.bn != b.bm:
        raise ValueError("inner block dims must agree")
    dev = a.blocks.device
    if b.blocks.device != dev or a.blocks.dtype != b.blocks.dtype:
        raise ValueError("spgemm: A and B blocks must share device and dtype")
    if plan.n != a.n_rows or plan.b != a.bm:
        raise ValueError("spgemm: the plan is of a matrix of other rows or "
                         "blocks (a plan of other matrices?)")
    if dev.type == "cpu":
        return _spgemm_plain(plan, a, b), plan.c_block_ij
    dp = _device_plan(plan, dev)
    if dp["nbr"] > a.nbr:
        raise ValueError("spgemm: the plan has C block rows past A's (a "
                         "plan of other matrices?)")
    suffix = _check_kernel_bsr("spgemm", a)
    _check_kernel_bsr("spgemm", b)
    rows, blocks = _strip_chunks(a.bm, b.bn, dp["max_row_blocks"],
                                 elem=a.blocks.element_size())
    ra = _kernel_layout(a, "_spgemm_layout")
    rb = ra if b is a else _kernel_layout(b, "_spgemm_layout")
    C = torch.empty((plan.c_blocks, a.bm, b.bn), dtype=a.blocks.dtype,
                    device=dev)
    fn = getattr(_cuda.library("spgemm_blocks"), f"spgemm_blocks_{suffix}")
    _cuda.launch_check("spgemm", fn(
        ra.row_ptr.data_ptr(), ra.col.data_ptr(), ra.val.data_ptr(),
        rb.row_ptr.data_ptr(), rb.col.data_ptr(), rb.val.data_ptr(),
        rb.n_rows, dp["c_row_ptr"].data_ptr(), dp["c_col"].data_ptr(),
        dp["nbr"], a.bm, b.bn, rows, blocks, C.data_ptr(),
        _cuda.stream_of(C)))
    spgemm.launches += 1
    return C, plan.c_block_ij


bsr_matvec.launches = 0
bsr_matmat.launches = 0
spgemm.launches = 0


def reset_launch_counts():
    bsr_matvec.launches = 0
    bsr_matmat.launches = 0
    spgemm.launches = 0
