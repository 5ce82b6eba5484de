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
``spgemm.launches``; ``reset_launch_counts``).
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


def _check_kernel_bsr(name, bsr: BsrMatrix):
    """What every BSR kernel takes: f64 contiguous blocks, int32 col ids and
    f64 mask, all on the current CUDA device."""
    dev = bsr.blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if bsr.blocks.dtype != torch.float64 or bsr.mask.dtype != torch.float64:
        raise TypeError(f"{name}: the kernel takes float64 blocks and mask")
    if bsr.col_ids.dtype != torch.int32:
        raise TypeError(f"{name}: the kernel takes int32 col_ids")
    for t in (bsr.blocks, bsr.col_ids, bsr.mask):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: blocks, col_ids and mask must be "
                             f"contiguous on {dev}")


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
    (bm <= 32, even bn) or raises."""
    x = _operand("bsr_matvec", bsr, x, 1)
    if bsr.blocks.device.type == "cpu":
        return _bsr_matvec_plain(bsr, x)
    _check_kernel_bsr("bsr_matvec", bsr)
    if bsr.bm > 32 or bsr.bn % 2 or bsr.blocks.data_ptr() % 16:
        raise ValueError(f"bsr_matvec: the kernel takes bm <= 32, even bn "
                         f"and 16-byte aligned blocks (got {bsr.bm}x{bsr.bn})")
    y = torch.empty(bsr.n_rows, dtype=x.dtype, device=x.device)
    fn = _cuda.library("bsr_spmv").bsr_spmv_f64
    _cuda.launch_check("bsr_matvec", fn(
        bsr.blocks.data_ptr(), bsr.col_ids.data_ptr(), bsr.mask.data_ptr(),
        x.data_ptr(), bsr.nbr, bsr.blocks_per_row, bsr.bm, bsr.bn,
        bsr.n_rows, bsr.n_cols, y.data_ptr(), _cuda.stream_of(x)))
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
    (bm * m <= 1024, block and X panel within shared memory) or raises."""
    X = _operand("bsr_matmat", bsr, X, 2)
    if bsr.blocks.device.type == "cpu":
        return _bsr_matmat_plain(bsr, X)
    _check_kernel_bsr("bsr_matmat", bsr)
    m = X.shape[1]
    if bsr.bm * m > 1024 or 8 * bsr.bn * (bsr.bm + m) > 232448:
        raise ValueError(f"bsr_matmat: the kernel takes bm * m <= 1024 and "
                         f"(bm + m) * bn doubles of shared memory <= 227 KB "
                         f"(got bm {bsr.bm}, bn {bsr.bn}, m {m})")
    Y = torch.empty((bsr.n_rows, m), dtype=X.dtype, device=X.device)
    if m:
        fn = _cuda.library("bsr_spmm").bsr_spmm_f64
        _cuda.launch_check("bsr_matmat", fn(
            bsr.blocks.data_ptr(), bsr.col_ids.data_ptr(),
            bsr.mask.data_ptr(), X.data_ptr(), bsr.nbr, bsr.blocks_per_row,
            bsr.bm, bsr.bn, m, bsr.n_rows, bsr.n_cols, Y.data_ptr(),
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
    blocks come from np.unique of the (i, j) keys. Ops are sorted by
    destination, and ``c_ptr`` gives each C block its op range, so the
    numeric phase streams each C block's products in one CTA."""
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


def _device_plan(plan: SpgemmPlan, device):
    """The plan's index arrays on ``device`` (int32 for the kernel, the
    destinations int64 for the plain version's ``index_add_``), uploaded
    once per (plan, device) and kept on the plan, with the storage sizes
    the indices need; checked here once."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    dp = cache.get(key)
    if dp is not None:
        return dp
    n_ops = len(plan.a_idx)
    if n_ops >= 2 ** 31:
        raise ValueError("spgemm: more than 2^31 block products")
    c_idx = np.asarray(plan.c_idx)
    if n_ops and (int(c_idx.min()) < 0 or int(c_idx.max()) >= plan.c_blocks
                  or (np.diff(c_idx) < 0).any()):
        raise ValueError("spgemm: plan destinations are not sorted C blocks")
    if not np.array_equal(plan.c_ptr, _c_ptr(c_idx, plan.c_blocks)):
        raise ValueError("spgemm: plan c_ptr does not match c_idx")

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    dp = cache[key] = {
        "a_idx": t(plan.a_idx, torch.int32),
        "b_idx": t(plan.b_idx, torch.int32),
        "c_ptr": t(plan.c_ptr, torch.int32),
        "c_idx": t(c_idx, torch.int64),
        "a_need": int(np.max(plan.a_idx)) + 1 if n_ops else 0,
        "b_need": int(np.max(plan.b_idx)) + 1 if n_ops else 0,
    }
    return dp


def _spgemm_plain(dp, a: BsrMatrix, b: BsrMatrix, c_blocks):
    """Plain PyTorch version of ``spgemm`` (kernels.py:366-372 of the
    reference package): batched block products, scatter-added into C."""
    A = a.blocks[dp["a_idx"].long()]
    B = b.blocks[dp["b_idx"].long()]
    C = torch.zeros((c_blocks, a.bm, b.bn), dtype=a.blocks.dtype,
                    device=a.blocks.device)
    return C.index_add_(0, dp["c_idx"], torch.bmm(A, B))


def spgemm(plan: SpgemmPlan, a: BsrMatrix, b: BsrMatrix):
    """Numeric SpGEMM C = A B over the planned block products.

    Returns (C, c_block_ij): C (c_blocks, bm, bn) on the blocks' device and
    the block coordinates of each C block — a BSR-like block list.

    Replaces the reference package's ``_spgemm_pallas``. A CPU tensor takes
    the plain version; a CUDA tensor launches ``csrc/spgemm_blocks.cu``
    (one CTA per C block over its ``c_ptr`` range; bm * bn <= 1024) or
    raises."""
    if a.bn != b.bm:
        raise ValueError("inner block dims must agree")
    dev = a.blocks.device
    if b.blocks.device != dev or a.blocks.dtype != b.blocks.dtype:
        raise ValueError("spgemm: A and B blocks must share device and dtype")
    dp = _device_plan(plan, dev)
    if (dp["a_need"] > a.blocks.shape[0]
            or dp["b_need"] > b.blocks.shape[0]):
        raise ValueError("spgemm: the plan indexes past the A or B block "
                         "storage (a plan of other matrices?)")
    if dev.type == "cpu":
        return _spgemm_plain(dp, a, b, plan.c_blocks), plan.c_block_ij
    _check_kernel_bsr("spgemm", a)
    _check_kernel_bsr("spgemm", b)
    if a.bm * b.bn > 1024 or 8 * a.bn * (a.bm + b.bn) > 232448:
        raise ValueError(f"spgemm: the kernel takes bm * bn <= 1024 and "
                         f"blocks within shared memory (got {a.bm}x{a.bn} "
                         f"@ {b.bm}x{b.bn})")
    C = torch.empty((plan.c_blocks, a.bm, b.bn), dtype=a.blocks.dtype,
                    device=dev)
    fn = _cuda.library("spgemm_blocks").spgemm_blocks_f64
    _cuda.launch_check("spgemm", fn(
        a.blocks.data_ptr(), b.blocks.data_ptr(), dp["a_idx"].data_ptr(),
        dp["b_idx"].data_ptr(), dp["c_ptr"].data_ptr(), plan.c_blocks,
        a.bm, a.bn, b.bn, C.data_ptr(), _cuda.stream_of(C)))
    spgemm.launches += 1
    return C, plan.c_block_ij


bsr_matvec.launches = 0
bsr_matmat.launches = 0
spgemm.launches = 0


def reset_launch_counts():
    bsr_matvec.launches = 0
    bsr_matmat.launches = 0
    spgemm.launches = 0
