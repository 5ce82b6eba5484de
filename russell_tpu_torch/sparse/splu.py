"""General sparse LU (SPLU) in PyTorch: block left-looking factorization
with host symbolic analysis.

Counterpart of ``russell_tpu.sparse.splu``. Reference role: the
JOB_ANALYZE / JOB_FACTORIZE split of russell_sparse/c_code/interface_mumps.c
and the symbolic/numeric phases of interface_umfpack.c.

- **symbolic (host, numpy)**: ordering (nested dissection or minimum
  degree), uniform b x b block partition, symbolic block fill and a fully
  static PACKED schedule. This part is copied from the reference package,
  so both packages build equal plans (every array equal).
- **numeric (device)**: a Python loop over schedule rows; the row scalars
  (``t0``, ``len``, ``nd``) are host ints, so no row waits on the device.
  Each row sums its block-pair products per live target lane (the
  ``splu_pairs`` CUDA kernel on the card, over a balanced work list of
  pair chunks built once per plan), subtracts them from the
  assembled values, inverts its diagonal lanes (``_inv_block``: recursive
  Schur splitting above ``GJ_MAX_M``, a Gauss-Jordan base with MUMPS-style
  static pivot clamping below it, the ``gj_inv`` CUDA kernel on the card),
  right-multiplies every other lane by a per-lane block gathered with the
  ``gather_rows`` CUDA kernel (a stored Dinv, the identity, or the row's
  freshly inverted diagonal) and writes the row's contiguous storage
  range in place.
- **solve (device)**: packed forward/backward block substitution; no
  triangular solves.

Complex matrices are stored as their real embedding K = [[R,-I],[I,R]]
per block (block size 2b), so the complex elimination is the real one and
all three kernels are real f64 kernels.

A batch of matrices of one pattern (entry values (B, nnz), right-hand sides
(B, n)) runs the same rows over a leading lane dimension: one block storage
(B, N, width) per kind, one launch of each kernel per row whatever B is,
one pivot threshold and one set of statistics per lane.

Each kernel's wrapper (``splu_pairs``, ``gather_rows``, ``_gj_inv``) is
the only place that chooses between the kernel and its plain PyTorch
version: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from russell_tpu_torch.sparse import _cuda
from russell_tpu_torch.sparse.ordering import (mindeg_ordering, rank_passes,
                                              segment_index)

__all__ = ["SpluPlan", "splu_analyze", "splu_factorize",
           "splu_factorize_multi", "splu_solve", "splu_solve_multi",
           "splu_pairs", "gather_rows", "reset_launch_counts", "PairWork",
           "CHUNK_PAIRS", "GJ_MAX_M", "splu_det_phase"]

# most pairs in one chunk of splu_pairs' work list (_pair_chunks): the
# longest chain one CTA walks in series (chosen from the sweep over K of
# ``chip_smoke.py --chunk-sweep``, PERF.md)
CHUNK_PAIRS = 4
# the largest block the clamped Gauss-Jordan base (``_gj_inv``, the
# ``gj_inv`` kernel, which holds up to 144 x 144 f64 in one CTA's
# registers) takes: ``_inv_block`` splits only blocks above it, on every
# device. The plans' pivot blocks are 32-143 or twice that; the value won
# ``chip_smoke.py --base-sweep`` (PERF.md)
GJ_MAX_M = 144


@dataclass
class SpluPlan:
    """Static description of a block-sparse LU (symbolic output)."""

    n: int
    b: int                      # block size
    nb: int                     # number of block rows/cols
    nblk: int                   # number of stored blocks (+1 scratch at 0)
    perm: np.ndarray            # symmetric permutation (new = perm position)
    scatter_idx: np.ndarray     # flat position per matrix entry
    pad_idx: np.ndarray         # unit-diagonal positions for padding rows
    diag_idx: np.ndarray        # (nb,) storage index of diagonal blocks
    pivot_epsilon: float = 1e-14
    fill_blocks: int = 0
    # elimination-tree level sets (diagnostics: tree depth/width; the
    # numeric schedule below is built from them). lvl_cols[t] lists the
    # block columns of level t, padded with nb (dummy).
    lvl_cols: Optional[np.ndarray] = None   # (nlev, max_w)
    # packed numeric schedule: COMPACT per-row work lists (no per-column
    # padding) — three row types run by one branch-free row body.
    # Built by _build_packed_left / _build_packed_solve.
    packed: Optional[dict] = None


def splu_analyze(n: int, rows: np.ndarray, cols: np.ndarray,
                 block_size: int = 32, use_amd: bool = True,
                 pivot_epsilon: float = 1e-14,
                 ordering: Optional[str] = None) -> SpluPlan:
    """Symbolic phase: ordering + block pattern + static schedules.

    ``ordering``: "amd" (fill-minimizing, default), "nd" (nested
    dissection: low-depth elimination tree -> wide level-batched numeric
    phase), or "natural"."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if ordering is None:
        ordering = "amd" if use_amd else "natural"
    b = max(8, int(block_size))
    if ordering == "nd":
        # region-ALIGNED slots: every ND region (leaf/separator) starts at
        # a block boundary, so no block straddles two independent regions
        # — this is what makes the elimination-tree levels WIDE (leaves of
        # disjoint subtrees share no block) and the batched numeric phase
        # effective. Unused slots get a unit diagonal.
        from russell_tpu_torch.sparse.ordering import nd_ordering
        order, sizes = nd_ordering(n, rows, cols, leaf=2 * b,
                                   with_regions=True)
        sizes = np.asarray(sizes, dtype=np.int64)
        starts = np.concatenate(
            [[0], np.cumsum(-(-sizes // b) * b)])
        total_slots = int(starts[-1])
        region_id = np.repeat(np.arange(len(sizes)), sizes)
        region_pos0 = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        slot = starts[region_id] + (np.arange(n) - region_pos0[region_id])
        perm_old2new = np.empty(n, dtype=np.int64)
        perm_old2new[order] = slot
        nb = total_slots // b
        used = np.zeros(nb * b, dtype=bool)
        used[slot] = True
    elif ordering == "amd":
        perm_old2new = np.empty(n, dtype=np.int64)
        order = mindeg_ordering(n, rows, cols)  # order[i] = old index
        perm_old2new[order] = np.arange(n)
        nb = -(-n // b)
        used = np.zeros(nb * b, dtype=bool)
        used[:n] = True
    else:
        perm_old2new = np.arange(n, dtype=np.int64)
        nb = -(-n // b)
        used = np.zeros(nb * b, dtype=bool)
        used[:n] = True

    r = perm_old2new[rows]
    c = perm_old2new[cols]
    bi = r // b
    bj = c // b

    # block pattern + symbolic fill; native C++ path when available
    base_pat = set(zip(bi.tolist(), bj.tolist()))
    from russell_tpu_torch import native
    filled = native.block_fill(nb, bi, bj)
    if filled is not None:
        pat = set(map(tuple, filled.tolist()))
        lower = [[] for _ in range(nb)]
        upper = [[] for _ in range(nb)]
        for (i, j) in pat:
            if i > j:
                lower[j].append(i)
            elif i < j:
                upper[i].append(j)
        for k in range(nb):
            lower[k] = sorted(set(lower[k]))
            upper[k] = sorted(set(upper[k]))
    else:
        pat = set(base_pat)
        for k in range(nb):
            pat.add((k, k))  # diagonal blocks always present
        # symbolic block fill (right-looking)
        lower = [[] for _ in range(nb)]   # lower[k] = [i > k with (i,k)]
        upper = [[] for _ in range(nb)]
        for (i, j) in pat:
            if i > j:
                lower[j].append(i)
            elif i < j:
                upper[i].append(j)
        for k in range(nb):
            Ls = sorted(set(lower[k]))
            Us = sorted(set(upper[k]))
            lower[k] = Ls
            upper[k] = Us
            for i in Ls:
                for j in Us:
                    if (i, j) not in pat:
                        pat.add((i, j))
                        if i > j:
                            lower[j].append(i)
                        elif i < j:
                            upper[i].append(j)
    fill_blocks = len(pat) - len(base_pat)

    # ---- storage assignment: LEFT-LOOKING, level-ordered -------------
    # Block (i, j) is FINALIZED when column k = min(i, j) is eliminated.
    # Storage is ordered by (elimination level of k, section, k, other)
    # with sections diag -> L -> U, so every level's writes form
    # CONTIGUOUS storage ranges: the numeric phase writes each row with
    # one slice write instead of a scatter.
    if filled is not None:
        codes = np.sort(filled[:, 0].astype(np.int64) * nb + filled[:, 1])
    else:
        codes = np.sort(np.fromiter((i * nb + j for (i, j) in pat),
                                    dtype=np.int64, count=len(pat)))
    nblk = len(codes) + 1
    ci = codes // nb
    cj = codes % nb
    ar = np.arange(nb, dtype=np.int64)

    # position-space boundaries (codes sorted by (i, j))
    rowptr = np.searchsorted(ci, np.arange(nb + 1))
    dpos = np.searchsorted(codes, ar * nb + ar)            # row-left end
    upos = np.searchsorted(codes, ar * nb + ar + 1)        # row-right start
    col_order = np.lexsort((ci, cj))
    ci_c = ci[col_order]
    keys_c = cj[col_order] * nb + ci_c
    colptr = np.searchsorted(keys_c, ar * nb)
    colptr = np.append(colptr, len(codes))
    ls_ = np.searchsorted(keys_c, ar * nb + ar + 1)        # col-lower start
    dc_ = np.searchsorted(keys_c, ar * nb + ar)            # col-upper end
    nl = colptr[1:] - ls_                                   # lower sizes
    nu = rowptr[1:] - upos                                  # upper sizes
    max_l = max(int(nl.max()) if nb else 1, 1)
    max_u = max(int(nu.max()) if nb else 1, 1)

    # elimination-tree levels: k depends on every j < k with (k,j) or
    # (j,k) present; deps all point backwards so one sweep suffices
    level = np.zeros(nb, dtype=np.int64)
    for k in range(nb):
        m1 = cj[rowptr[k]:dpos[k]]              # (k, j), j < k
        m2 = ci_c[colptr[k]:dc_[k]]             # (j, k), j < k
        lv = 0
        if len(m1):
            lv = int(level[m1].max()) + 1
        if len(m2):
            lv = max(lv, int(level[m2].max()) + 1)
        level[k] = lv
    nlev = int(level.max()) + 1 if nb else 1
    order_lv = np.argsort(level, kind="stable")
    bptr = np.searchsorted(level[order_lv], np.arange(nlev + 1))
    buckets = [order_lv[bptr[t]:bptr[t + 1]] for t in range(nlev)]

    # storage permutation: position -> level-ordered storage id (1-based)
    own_k = np.minimum(ci, cj)
    other = np.maximum(ci, cj)
    section = np.where(ci == cj, 0, np.where(ci > cj, 1, 2))
    blk_lvl = level[own_k]
    ord_st = np.lexsort((other, own_k, section, blk_lvl))
    st_perm = np.empty(len(codes), dtype=np.int64)
    st_perm[ord_st] = np.arange(1, len(codes) + 1)

    def store(ii_, jj_):
        posq = np.searchsorted(codes, np.asarray(ii_) * nb
                               + np.asarray(jj_))
        return st_perm[posq]

    # storage-space boundaries of every (level, section) run
    sec_key = (blk_lvl * 3 + section)[ord_st]
    sec_bounds = np.searchsorted(sec_key, np.arange(3 * nlev + 1)) + 1

    st_c = st_perm[col_order]                  # column-major storages

    scatter_idx = (store(bi, bj) * b * b + (r - bi * b) * b
                   + (c - bj * b)).astype(np.int64)
    pad = np.flatnonzero(~used).astype(np.int64)
    if len(pad):
        pad_bi = pad // b
        pad_loc = pad - pad_bi * b
        pad_idx = (store(pad_bi, pad_bi) * b * b + pad_loc * b
                   + pad_loc).astype(np.int64)
    else:
        pad_idx = np.zeros(0, dtype=np.int64)
    diag_idx = store(ar, ar)

    # level columns, padded (tree-depth/width diagnostics)
    max_w = max((len(bk) for bk in buckets), default=1) or 1
    lvl_cols = np.full((max(len(buckets), 1), max_w), nb, dtype=np.int64)
    for t, bk in enumerate(buckets):
        lvl_cols[t, :len(bk)] = bk

    packed = _build_packed_left(
        nb, nblk, nlev, buckets, b, store, diag_idx, sec_bounds,
        st_c, ci_c, ls_, colptr, cj, upos, rowptr, nl, nu,
        st_perm, ord_st, ci, section, blk_lvl, own_k, other)
    packed["fwd"] = _build_packed_solve(nb, buckets, b, rowptr[:-1],
                                        dpos, cj, st_perm)
    packed["bwd"] = _build_packed_solve(nb, list(reversed(buckets)), b,
                                        upos, rowptr[1:], cj, st_perm)

    return SpluPlan(
        n=n, b=b, nb=nb, nblk=nblk, perm=perm_old2new,
        scatter_idx=scatter_idx, pad_idx=pad_idx, diag_idx=diag_idx,
        pivot_epsilon=pivot_epsilon, fill_blocks=fill_blocks,
        lvl_cols=lvl_cols, packed=packed)


def _build_packed_left(nb, nblk, nlev, buckets, bsz, store, diag_idx,
                       sec_bounds, st_c, ci_c, ls_, colptr, cj, upos,
                       rowptr, nl, nu, st_perm, ord_st, ci, section,
                       blk_lvl, own_k, other):
    """LEFT-LOOKING packed schedule (vectorized construction).

    Contributions Lhat(i,m) @ U(m,j) are grouped by their TARGET block
    (i, j); storage is ordered by the target's finalization level and
    section, so every scan row finalizes one CONTIGUOUS storage range
    [t0, t0+len): gather pairs, segment-sum, subtract from the assembled
    values, post-process by section (invert diagonals / right-multiply
    L panels by Dinv / keep U panels), and write back with ONE slice
    write. No scatters anywhere.

    Row types: 0 = diagonal range, 1 = L range, 2 = U range."""
    bb = bsz * bsz
    TL = max(64, min(1024, 4_000_000 // bb))       # target slots per row
    # pairs per row: every row pays the FULL padded gather (~Ccap * bb
    # floats x3), so a tight cap beats fewer-but-padded rows
    Ccap = max(256, 2_097_152 // bb)

    # enumerate ALL contribution pairs, grouped per SOURCE column m
    l_parts, u_parts, t_parts = [], [], []
    for cols in buckets:
        cols = np.asarray(cols, dtype=np.int64)
        if not len(cols) or not int((nl[cols] * nu[cols]).sum()):
            continue
        i_all = np.concatenate(
            [np.repeat(ci_c[ls_[m]:colptr[m + 1]], nu[m]) for m in cols])
        l_all = np.concatenate(
            [np.repeat(st_c[ls_[m]:colptr[m + 1]], nu[m]) for m in cols])
        j_all = np.concatenate(
            [np.tile(cj[upos[m]:rowptr[m + 1]], nl[m]) for m in cols])
        u_all = np.concatenate(
            [np.tile(st_perm[np.arange(upos[m], rowptr[m + 1])], nl[m])
             for m in cols])
        l_parts.append(l_all)
        u_parts.append(u_all)
        t_parts.append(store(i_all, j_all))
    if t_parts:
        l_glob = np.concatenate(l_parts)
        u_glob = np.concatenate(u_parts)
        t_glob = np.concatenate(t_parts)
        srt = np.argsort(t_glob, kind="stable")
        l_glob, u_glob, t_glob = l_glob[srt], u_glob[srt], t_glob[srt]
    else:
        l_glob = u_glob = t_glob = np.zeros(0, dtype=np.int64)
    # pairs-per-storage-slot prefix (storage ids 1..nblk-1)
    pair_ptr = np.searchsorted(t_glob, np.arange(1, nblk + 1))
    Ccap = int(max(Ccap, np.diff(np.concatenate([[0], pair_ptr])).max()
                   if nblk > 1 else 1))

    # per-L-block diagonal storage (for the Dinv right-multiply),
    # indexed by storage id
    dinv_of_storage = np.zeros(nblk, dtype=np.int64)
    lmask = section[ord_st] == 1                 # storage-ordered sections
    lstor = np.arange(1, nblk)[lmask]
    lcols = own_k[ord_st][lmask]
    dinv_of_storage[lstor] = diag_idx[lcols]

    # ---- row emission -----------------------------------------------
    # Row types: 0 = diag range (invert), 1 = panel range (merged L+U:
    # L lanes multiply by the ALREADY-WRITTEN Dinv from block storage, U
    # lanes by a dedicated IDENTITY block — one einsum serves both),
    # 2 = MERGED level (diag + L + U in ONE row: the L lanes use the
    # Dinv computed in-row, so a whole elimination-tree level costs one
    # scan step). A level falls back to 0+1 rows only when it exceeds
    # the TL/Ccap caps. Pair arrays carry NO dummy lanes: the port's
    # pair kernel finds each lane's pairs through a per-row segment
    # pointer (_seg_ptr) instead.
    id_slot = nblk + TL          # identity block appended by _init_states
    # diag lanes are a PREFIX of every row; capping them (NDcap << TL)
    # bounds the per-row batched-inversion cost, which every row pays in
    # the branch-free body
    ND_EMIT = min(TL, 256)
    rows = []   # (rtype, t0, ln, nd, p0, p1)

    def emit(sec, s0, s1, cap):
        pos = s0
        while pos < s1:
            ln = min(cap, s1 - pos)
            p0 = pair_ptr[pos - 1] if pos > 1 else 0
            # shrink ln so the pair count fits Ccap
            while ln > 1 and (pair_ptr[pos + ln - 1] - p0) > Ccap:
                ln -= 1
            p1 = pair_ptr[pos + ln - 1]
            rows.append((sec, pos, ln, ln if sec == 0 else 0, p0, p1))
            pos += ln

    for t in range(nlev):
        d0 = int(sec_bounds[t * 3])
        d1 = int(sec_bounds[t * 3 + 1])
        u1 = int(sec_bounds[t * 3 + 3])
        total = u1 - d0
        if total <= 0:
            continue
        nd = d1 - d0
        p0 = pair_ptr[d0 - 1] if d0 > 1 else 0
        p1 = pair_ptr[u1 - 1] if u1 > 1 else 0
        if total <= TL and nd <= ND_EMIT and (p1 - p0) <= Ccap:
            rows.append((2, d0, total, nd, p0, p1))
        else:
            emit(0, d0, d1, ND_EMIT)
            emit(1, d1, u1, TL)

    nrows = max(len(rows), 1)
    NDcap = max(8, max((r[3] for r in rows), default=8))
    r_type = np.zeros(nrows, dtype=np.int32)
    r_t0 = np.zeros(nrows, dtype=np.int32)
    r_len = np.zeros(nrows, dtype=np.int32)
    r_nd = np.zeros(nrows, dtype=np.int32)
    pair_l = np.zeros((nrows, Ccap), dtype=np.int32)
    pair_u = np.zeros((nrows, Ccap), dtype=np.int32)
    pair_seg = np.full((nrows, Ccap), TL, dtype=np.int32)
    dinv_a = np.full((nrows, TL), id_slot, dtype=np.int32)
    dloc_a = np.full((nrows, TL), NDcap, dtype=np.int32)
    for rr, (sec, t0, ln, nd, p0, p1) in enumerate(rows):
        r_type[rr] = sec
        r_t0[rr] = t0
        r_len[rr] = ln
        r_nd[rr] = nd
        npair = p1 - p0
        pair_l[rr, :npair] = l_glob[p0:p1]
        pair_u[rr, :npair] = u_glob[p0:p1]
        pair_seg[rr, :npair] = t_glob[p0:p1] - t0
        if sec == 1:
            dv = dinv_of_storage[t0:t0 + ln]
            dinv_a[rr, :ln] = np.where(dv > 0, dv, id_slot)
        elif sec == 2:
            dv = dinv_of_storage[t0:t0 + ln]
            # in-row lane index of the freshly inverted diagonal (NDcap
            # = identity lane for diag/U slots)
            dloc_a[rr, :ln] = np.where(dv > 0, dv - t0, NDcap)
    return {
        "r_type": r_type, "t0": r_t0, "len": r_len, "nd": r_nd,
        "pair_l": pair_l, "pair_u": pair_u, "pair_seg": pair_seg,
        "dinv": dinv_a, "dloc": dloc_a, "TL": TL, "Ccap": Ccap,
        "NDcap": NDcap,
    }


def _build_packed_solve(nb, buckets, bsz, start_arr, end_arr, cj,
                        st_perm):
    """Packed substitution schedule for one direction (vectorized).

    Row k's couplings live at row-major positions [start_arr[k],
    end_arr[k]) — storage = position + 1, source column = cj[position].
    Groups stay COMPLETE within a row (targets are written with set)."""
    cap_items = max(256, 4_000_000 // (bsz * bsz))
    sizes_all = (end_arr - start_arr).astype(np.int64)
    # bound caps by the LARGEST level's real needs (padding is work)
    max_lvl = 1
    max_row = 1
    max_w = 1
    for cols in buckets:
        cols = np.asarray(cols, dtype=np.int64)
        if len(cols):
            sz = sizes_all[cols]
            max_lvl = max(max_lvl, int(sz.sum()))
            max_row = max(max_row, int(sz.max()))
            max_w = max(max_w, len(cols))
    Ccap = int(max(min(cap_items, max(64, max_lvl)), max_row))
    Ucap = int(min(max(1024, cap_items // 8), max(32, max_w)))

    rows = []
    for cols in buckets:
        cols = np.asarray(cols, dtype=np.int64)
        if not len(cols):
            continue
        sz = sizes_all[cols]
        csum = np.cumsum(sz)
        g0 = 0
        G = len(cols)
        while g0 < G:
            base = csum[g0 - 1] if g0 else 0
            gi = int(np.searchsorted(csum, base + Ccap, side="right"))
            gi = max(min(gi, g0 + Ucap, G), g0 + 1)
            ck = cols[g0:gi]
            src = np.concatenate(
                [np.zeros(0, dtype=np.int64)]
                + [st_perm[start_arr[k]:end_arr[k]] for k in ck])
            col = np.concatenate(
                [np.zeros(0, dtype=np.int64)]
                + [cj[start_arr[k]:end_arr[k]] for k in ck])
            seg = np.repeat(np.arange(gi - g0, dtype=np.int64), sz[g0:gi])
            rows.append((ck, src, col, seg))
            g0 = gi

    nrows = max(len(rows), 1)
    s_src = np.zeros((nrows, Ccap), dtype=np.int32)
    s_col = np.zeros((nrows, Ccap), dtype=np.int32)
    s_seg = np.full((nrows, Ccap), Ucap, dtype=np.int32)
    s_tgt_g = np.zeros((nrows, Ucap), dtype=np.int32)
    s_tgt_s = np.tile(nb + np.arange(Ucap, dtype=np.int32), (nrows, 1))
    for rr, (ck, src, col, seg) in enumerate(rows):
        s_tgt_g[rr, :len(ck)] = ck
        s_tgt_s[rr, :len(ck)] = ck
        s_src[rr, :len(src)] = src
        s_col[rr, :len(col)] = col
        s_seg[rr, :len(seg)] = seg
    return {"src": s_src, "col": s_col, "seg": s_seg,
            "tgt_g": s_tgt_g, "tgt_s": s_tgt_s, "Ucap": Ucap}


def _kform_indices(plan: SpluPlan):
    """Map each entry's real-layout position (st*b*b + r*b + c) to its
    FOUR positions in the [[R,-I],[I,R]] real-embedding block (2b x 2b,
    row-major): Re at (r, c) and (r+b, c+b); Im at (r+b, c) and -Im at
    (r, c+b). Host-side numpy (plan arrays are host)."""
    b = plan.b
    bb = b * b
    b2 = 2 * b
    idx = np.asarray(plan.scatter_idx)
    st = idx // bb
    rem = idx - st * bb
    r = rem // b
    c = rem - r * b
    base = st * (4 * bb)
    return (base + r * b2 + c,                # +Re
            base + (r + b) * b2 + (c + b),    # +Re
            base + (r + b) * b2 + c,          # +Im
            base + r * b2 + (c + b))          # -Im


# ---------------------------------------------------------------------------
# the two kernels: wrappers and plain versions
# ---------------------------------------------------------------------------


def _check_kernel_args(name, blocks, index_tensors):
    if blocks.dtype != torch.float64:
        raise TypeError(f"{name}: blocks must be float64, got {blocks.dtype}")
    if blocks.dim() not in (2, 3) or not blocks.is_contiguous():
        raise ValueError(f"{name}: blocks must be a contiguous (N, W) or "
                         "(lanes, N, W) tensor")
    for t in index_tensors:
        if t.device != blocks.device:
            raise ValueError(f"{name}: index tensors must be on "
                             f"{blocks.device}, got {t.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: index tensors must be contiguous "
                             "1-D int32")


def _splu_pairs_plain(blocks, pair_l, pair_u, pair_seg, n_live, be):
    """Plain PyTorch version of ``splu_pairs`` (splu.py:878-891 of the
    reference package): batched products of the gathered blocks, summed
    per segment into an (n_live + 1)-row buffer whose last row takes the
    pads (every segment >= n_live) and is dropped; per lane for (lanes, N,
    W) blocks."""
    lead = blocks.shape[:-2]
    Ls = blocks.index_select(-2, pair_l).view(-1, be, be)
    Us = blocks.index_select(-2, pair_u).view(-1, be, be)
    prod = torch.bmm(Ls, Us).view(lead + (-1, be * be))
    out = torch.zeros(lead + (n_live + 1, be * be), dtype=blocks.dtype,
                      device=blocks.device)
    out.index_add_(-2, pair_seg.clamp(max=n_live), prod)
    return out[..., :n_live, :]


@dataclass(frozen=True)
class PairWork:
    """``splu_pairs``' balanced work list for one factorize row, built on
    the host once per plan (``_pair_chunks``) and uploaded by
    ``_device_plan``. Each chunk is at most K consecutive pairs of one
    lane; a live lane without pairs has one empty chunk; the lanes with
    the most chunks come first, so the chunks of multi-chunk lanes are a
    prefix of ``n_multi`` chunks."""

    chunk: torch.Tensor     # (n_chunks, 4) int32: lane, first pair,
    #                         pairs, chunks of that lane
    lane_off: torch.Tensor  # (n_live,) int32: each lane's first chunk
    n_multi: int


# splu_pairs' per-lane tickets, one zeroed int32 buffer per (device,
# stream): the last CTA of a multi-chunk lane resets its ticket, and the
# launches on one stream run in order, so every plan may share a stream's
# buffer, while launches on two streams never share one
_tickets: dict = {}


def _stream_tickets(device, stream, n):
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def prepare_stream(plan: SpluPlan, device, stream, lanes: int = 1):
    """Create the ticket buffer of the CUDA ``stream`` at the plan's
    widest row times ``lanes`` (a batch's matrices) before a CUDA graph
    capture on it (a buffer created during a capture would come from the
    graph's memory pool)."""
    dp = _device_plan(plan, device)
    n = max(ln for _, ln, *_ in dp["rows"])
    _stream_tickets(torch.device(device), stream.cuda_stream, n * lanes)


def splu_pairs(blocks, pair_l, pair_u, pair_seg, work, n_live, be):
    """Segment-summed block-pair products of one factorize row:
    ``out[s] = sum_{i: pair_seg[i] == s} B[pair_l[i]] @ B[pair_u[i]]`` for
    the ``n_live`` live lanes s, with B = ``blocks`` viewed as
    (N, be, be). Pairs are sorted by segment; pairs of segment >= n_live
    are pads (the plan puts no real pair there, ``_device_plan`` checks).
    ``work`` is the row's ``PairWork``. Returns (n_live, be*be); blocks
    (lanes, N, be*be) of a batch give (lanes, n_live, be*be), each lane
    summed over its own blocks with the one work list, in one launch.

    Replaces the reference package's ``_pairs_pallas`` (whose lanes past
    the row's ``len`` are always zero). A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/splu_pairs.cu`` or raises.
    Index ranges are plan constants, checked once per plan by
    ``_device_plan``."""
    _check_kernel_args("splu_pairs", blocks,
                       (pair_l, pair_u, pair_seg, work.lane_off))
    chunk = work.chunk
    if (chunk.device != blocks.device or chunk.dtype != torch.int32
            or chunk.dim() != 2 or chunk.shape[1] != 4
            or not chunk.is_contiguous()):
        raise ValueError("splu_pairs: work.chunk must be a contiguous "
                         f"(n, 4) int32 tensor on {blocks.device}")
    if blocks.shape[-1] != be * be:
        raise ValueError(f"splu_pairs: blocks must be (N, be*be), got "
                         f"be={be}, {tuple(blocks.shape)}")
    if not (pair_l.shape == pair_u.shape == pair_seg.shape):
        raise ValueError("splu_pairs: pair arrays differ in length")
    n_chunks = chunk.shape[0]
    if not (0 < n_live <= min(n_chunks, work.lane_off.shape[0])
            and 0 <= work.n_multi <= n_chunks):
        raise ValueError(f"splu_pairs: n_live {n_live} and n_multi "
                         f"{work.n_multi} do not fit the work list")
    if blocks.device.type == "cpu":
        return _splu_pairs_plain(blocks, pair_l, pair_u, pair_seg, n_live,
                                 be)
    if blocks.device.type != "cuda":
        raise ValueError(f"splu_pairs: no kernel for {blocks.device}")
    if be not in (16, 32, 64) or blocks.data_ptr() % 16:
        raise ValueError(f"splu_pairs: the kernel takes be 16, 32 or 64 "
                         f"(got {be}) and 16-byte aligned blocks")
    lead = blocks.shape[:-2]
    lanes = blocks.shape[0] if lead else 1
    stream = _cuda.stream_of(blocks)
    tickets = _stream_tickets(blocks.device, stream, lanes * n_live)
    out = torch.empty(lead + (n_live, be * be), dtype=blocks.dtype,
                      device=blocks.device)
    # one partial per chunk of the multi-chunk lanes, per matrix
    scratch = (torch.empty((lanes, work.n_multi, be * be),
                           dtype=blocks.dtype, device=blocks.device)
               if work.n_multi else None)
    fn = _cuda.library("splu_pairs").splu_pairs_f64
    _cuda.launch_check("splu_pairs", fn(
        blocks.data_ptr(), pair_l.data_ptr(), pair_u.data_ptr(),
        chunk.data_ptr(), work.lane_off.data_ptr(), tickets.data_ptr(),
        n_chunks, n_live, work.n_multi, be, lanes, blocks.stride(0) if lead
        else 0, out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream))
    splu_pairs.launches += 1
    return out


def _gather_rows_plain(blocks, idx):
    """Plain PyTorch version of ``gather_rows``."""
    return blocks.index_select(-2, idx)


def gather_rows(blocks, idx):
    """Row gather ``blocks[idx]`` of a contiguous (N, W) f64 tensor with
    even W; of each lane's rows, ``blocks[:, idx]`` (lanes, n, W), for
    (lanes, N, W) blocks, in one launch. Replaces the reference package's
    ``_gather_rows``. A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/gather_rows.cu`` or raises. Index ranges are plan
    constants, checked once per plan by ``_device_plan``."""
    _check_kernel_args("gather_rows", blocks, (idx,))
    if blocks.device.type == "cpu":
        return _gather_rows_plain(blocks, idx)
    if blocks.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for {blocks.device}")
    lead = blocks.shape[:-2]
    W = blocks.shape[-1]
    if W % 2 or blocks.data_ptr() % 16 or (lead and blocks.stride(0) % 2):
        raise ValueError("gather_rows: rows must have an even width and "
                         "blocks be 16-byte aligned")
    out = torch.empty(lead + (idx.shape[0], W), dtype=blocks.dtype,
                      device=blocks.device)
    fn = _cuda.library("gather_rows").gather_rows_f64
    _cuda.launch_check("gather_rows", fn(
        blocks.data_ptr(), idx.data_ptr(), idx.shape[0], W,
        blocks.shape[0] if lead else 1, blocks.stride(0) if lead else 0,
        out.data_ptr(), _cuda.stream_of(blocks)))
    gather_rows.launches += 1
    return out


def segment_sum(vals, order, offsets):
    """Per-segment sums along dim 0 of ``vals`` (real or complex), the
    segments given by ``ordering.segment_index``: ``order`` (or None) puts
    the rows in segment order and ``offsets`` bounds each segment's run.
    ``torch.segment_reduce`` adds a segment's rows in that order without
    atomics, so the card gives the same bits on every run, and the CPU
    adds them left to right from zero, as ``index_add_`` does."""
    v = vals if order is None else vals.index_select(0, order)
    if v.is_complex():
        return torch.view_as_complex(torch.segment_reduce(
            torch.view_as_real(v.contiguous()), "sum", offsets=offsets,
            axis=0, unsafe=True))
    return torch.segment_reduce(v, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def reset_launch_counts():
    splu_pairs.launches = 0
    gather_rows.launches = 0
    _gj_inv.launches = 0


# ---------------------------------------------------------------------------
# plan arrays on the device
# ---------------------------------------------------------------------------


def _seg_ptr(pair_seg, TL):
    """Per-row lane pointers into the segment-sorted pair arrays: lane s of
    row r owns pairs ``seg_ptr[r, s]:seg_ptr[r, s+1]``; pads (segment TL)
    start at ``seg_ptr[r, TL]``. (nrows, TL + 1) int32."""
    lanes = np.arange(TL + 1)
    return np.stack([np.searchsorted(row, lanes, side="left")
                     for row in pair_seg]).astype(np.int32)


def _pair_chunks(seg_ptr, ln, K=None):
    """Balanced work list of one factorize row for ``splu_pairs``: each
    live lane s < ``ln`` (pairs ``seg_ptr[s]:seg_ptr[s+1]``) is cut into
    ceil(pairs / K) chunks of near-equal size, at most K consecutive pairs
    each; a lane without pairs gets one empty chunk. Lanes with more
    chunks come first (stable in lane order) and each lane's chunks are
    consecutive, in pair order. Returns (chunk, lane_off, n_multi):
    ``chunk`` (n_chunks, 4) int32 rows (lane, first pair, pairs, chunks
    of the lane); ``lane_off`` (ln,) int32, each lane's first chunk;
    ``n_multi`` the chunks of multi-chunk lanes, a prefix of the list."""
    K = CHUNK_PAIRS if K is None else int(K)
    starts = np.asarray(seg_ptr[:ln], dtype=np.int64)
    counts = np.asarray(seg_ptr[1:ln + 1], dtype=np.int64) - starts
    nck = np.maximum(1, -(-counts // K))
    order = np.argsort(-nck, kind="stable")
    nck_o = nck[order]
    off_o = np.cumsum(nck_o) - nck_o
    lane_off = np.empty(ln, dtype=np.int64)
    lane_off[order] = off_o
    lane = np.repeat(order, nck_o)
    j = np.arange(int(nck_o.sum())) - np.repeat(off_o, nck_o)
    c, n = nck[lane], counts[lane]
    lo, hi = n * j // c, n * (j + 1) // c
    chunk = np.stack([lane, starts[lane] + lo, hi - lo, c], axis=1)
    return (chunk.astype(np.int32), lane_off.astype(np.int32),
            int(nck_o[nck_o > 1].sum()))


def _chunk_arrays(seg_ptrs, lens):
    """``_pair_chunks`` of every factorize row, stacked for one upload:
    (chunks per row, (nrows, most chunks, 4) chunk rows, (nrows, most
    lanes) lane offsets)."""
    chunks = [_pair_chunks(sp, int(ln)) for sp, ln in zip(seg_ptrs, lens)]
    ck_cap = max(len(c) for c, _, _ in chunks)
    ln_cap = max(len(off) for _, off, _ in chunks)
    chunk_a = np.zeros((len(chunks), ck_cap, 4), dtype=np.int32)
    lane_off_a = np.zeros((len(chunks), ln_cap), dtype=np.int32)
    for r, (c, off, _) in enumerate(chunks):
        chunk_a[r, :len(c)] = c
        lane_off_a[r, :len(off)] = off
    return chunks, chunk_a, lane_off_a


def _work_lists(chunks, chunk_t, lane_off_t):
    return [PairWork(chunk_t[r, :len(c)], lane_off_t[r, :len(off)], n_multi)
            for r, (c, off, n_multi) in enumerate(chunks)]


def _rank_pairs(plan: SpluPlan, device, world: int, rank: int):
    """Rank ``rank`` of ``world``'s share of every factorize row's pairs,
    split as the reference package's ``dist_splu_factorize`` splits them:
    a row's pair columns, padded to a multiple of ``world`` (pads: l = u =
    0, segment TL, dropped), are cut into ``world`` equal runs, and rank r
    takes run r. Returns one (first live pair, end, PairWork) per row: the
    live pairs of the rank's run and ``splu_pairs``' chunk schedule over
    them (a lane without pairs in the run gets an empty chunk and sums to
    zero). Built once per (plan, device, world, rank) and kept with the
    plan's device arrays; a world of 1 gets the single-device schedule."""
    dp = _device_plan(plan, device)
    key = ("rank_pairs", world, rank)
    got = dp.get(key)
    if got is not None:
        return got
    pk = plan.packed
    TL = pk["TL"]
    run = -(-pk["pair_l"].shape[1] // world)
    spans = [(min(rank * run, npair), min((rank + 1) * run, npair))
             for _, _, _, npair, *_ in dp["rows"]]
    seg_ptrs = [_seg_ptr(pk["pair_seg"][r:r + 1, p0:p1], TL)[0]
                for r, (p0, p1) in enumerate(spans)]
    chunks, chunk_a, lane_off_a = _chunk_arrays(seg_ptrs, pk["len"])
    work = _work_lists(
        chunks, torch.as_tensor(chunk_a, device=device),
        torch.as_tensor(lane_off_a, device=device))
    got = dp[key] = [(p0, p1, w) for (p0, p1), w in zip(spans, work)]
    return got


def _check_range(name, a, hi):
    if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
        raise ValueError(f"plan array {name} leaves [0, {hi})")


def _device_solve(sched, nb, device):
    src, seg, tgt_s = sched["src"], sched["seg"], sched["tgt_s"]
    # live items and targets are a row PREFIX: pads carry seg = Ucap and
    # tgt_s = nb + k (the reference drops them with segment_sum's extra
    # segment and mode="drop"; here the host counts cut them off)
    n_src = (seg < sched["Ucap"]).sum(axis=1)
    n_tgt = (tgt_s < nb).sum(axis=1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=device)

    # each row's items summed per target (segment_sum)
    sums = []
    for r in range(len(n_src)):
        order, offsets = segment_index(seg[r, :n_src[r]], n_tgt[r])
        sums.append((None if order is None else t(order), t(offsets)))
    return {"rows": list(zip(n_src.tolist(), n_tgt.tolist())),
            "src": t(src), "col": t(sched["col"]), "tgt": t(sched["tgt_g"]),
            "sums": sums}


def _device_plan(plan: SpluPlan, device):
    """The plan's index arrays on ``device``, uploaded once per (plan,
    device) and kept on the plan object (the reference package's
    factor.py:1017-1025 does the same). The index ranges the kernels rely
    on are checked here, once."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    dp = cache.get(key)
    if dp is not None:
        return dp
    pk = plan.packed
    b, nb, nblk = plan.b, plan.nb, plan.nblk
    bb = b * b
    b2 = 2 * b
    TL, NDcap = pk["TL"], pk["NDcap"]
    nrow_store = nblk + TL + 1
    pair_seg = pk["pair_seg"]
    seg_ptr = _seg_ptr(pair_seg, TL)
    npair = seg_ptr[:, TL]
    # merged rows right-multiply their L lanes by the row's fresh inverse
    # (dloc < NDcap); remap the identity lane NDcap to nd, the index of
    # the identity appended to the row's nd inverted blocks
    dloc = pk["dloc"]
    fresh = dloc < NDcap
    dloc_r = np.where(fresh, dloc, pk["nd"][:, None])
    for name in ("pair_l", "pair_u", "dinv"):
        _check_range(name, pk[name], nrow_store)
    _check_range("pair_seg", pair_seg, TL + 1)
    if (np.diff(pair_seg.astype(np.int64), axis=1) < 0).any():
        raise ValueError("plan pair segments are not sorted")
    if (pk["t0"] + TL > nrow_store).any():
        raise ValueError("plan row window leaves the block storage")
    # splu_pairs writes the live lanes only: no real pair may target a
    # segment at or past the row's len
    lens = pk["len"].astype(np.int64)
    if (seg_ptr[np.arange(len(lens)), lens] != npair).any():
        raise ValueError("plan pairs target segments at or past the row's "
                         "live lanes (len)")
    chunks, chunk_a, lane_off_a = _chunk_arrays(seg_ptr, lens)

    # assembly positions: unit diagonals (identity slot + padding rows)
    # and the four K-embedding positions of every complex entry
    ones_r = np.concatenate([
        (nblk + TL) * bb + np.arange(b) * b + np.arange(b), plan.pad_idx])
    pidx = np.asarray(plan.pad_idx)
    pst = pidx // bb
    pl_ = (pidx - pst * bb) // b
    pbase = pst * (4 * bb)
    ones_k = np.concatenate([
        (nblk + TL) * 4 * bb + np.arange(b2) * b2 + np.arange(b2),
        pbase + pl_ * b2 + pl_, pbase + (pl_ + b) * b2 + (pl_ + b)])

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    kform = _kform_indices(plan)
    chunk_t = t(chunk_a, torch.int32)
    lane_off_t = t(lane_off_a, torch.int32)
    dp = {
        # t0, len, nd, live pairs, fresh inverse used, chunks, multi chunks
        "rows": [(int(pk["t0"][r]), int(pk["len"][r]), int(pk["nd"][r]),
                  int(npair[r]), bool(fresh[r].any()), len(chunks[r][0]),
                  chunks[r][2])
                 for r in range(len(pk["t0"]))],
        "work": _work_lists(chunks, chunk_t, lane_off_t),
        "pair_l": t(pk["pair_l"], torch.int32),
        "pair_u": t(pk["pair_u"], torch.int32),
        "pair_seg": t(pair_seg, torch.int32),
        "dinv": t(pk["dinv"], torch.int32),
        "dloc": t(dloc_r),
        "fresh": t(fresh, torch.bool),
        # the entries' storage positions in passes of one duplicate rank:
        # (entry ids, real-layout positions, the four K-form positions)
        "scatter_passes": [
            (t(ids), t(plan.scatter_idx[ids]),
             tuple(t(k[ids]) for k in kform))
            for ids in rank_passes(plan.scatter_idx)],
        "ones_r": t(ones_r),
        "ones_k": t(ones_k),
        "perm": t(plan.perm),
        "diag_g": t(np.append(plan.diag_idx, 0)),
        "fwd": _device_solve(pk["fwd"], nb, device),
        "bwd": _device_solve(pk["bwd"], nb, device),
    }
    cache[key] = dp
    return dp


# ---------------------------------------------------------------------------
# numeric factorization
# ---------------------------------------------------------------------------


def _lane_delta(delta, w):
    """The pivot threshold of each of ``w`` lanes: ``delta`` holds one
    value, or one per run of w / len(delta) consecutive lanes."""
    d = torch.as_tensor(delta).reshape(-1)
    if d.numel() == 1:
        return d.reshape(())
    if d.numel() == 0 or w % d.numel():
        raise ValueError(f"gj_inv: {d.numel()} pivot thresholds do not "
                         f"split {w} lanes")
    return d.repeat_interleave(w // d.numel())


def _gj_inv_plain(D, delta):
    """Plain PyTorch version of ``_gj_inv`` (the reference package's
    ``_gj_inv``, splu.py:476-513): the elimination as torch ops over the
    batch, one step at a time, with the per-lane statistics summed step by
    step in the reference's order. Also takes complex dtypes."""
    w, m = D.shape[0], D.shape[-1]
    dtype = D.dtype
    rdt = D.real.dtype if D.is_complex() else dtype
    eye = torch.eye(m, dtype=dtype, device=D.device)
    # augmented [D | I] so each elimination step is ONE rank-1 update
    W = torch.cat([D, eye.expand(w, m, m)], dim=-1)
    d = _lane_delta(delta, w).to(rdt)
    ld = torch.zeros(w, dtype=rdt, device=D.device)
    mp = torch.full((w,), float("inf"), dtype=rdt, device=D.device)
    npert = torch.zeros(w, dtype=torch.int32, device=D.device)
    ph = torch.ones(w, dtype=dtype, device=D.device)
    for j in range(m):
        pj = W[:, j, j]
        ap = pj.abs()
        mp = torch.minimum(mp, ap)
        bad = ap <= d
        npert = npert + bad.to(torch.int32)
        unit = torch.where(ap > 0, pj / ap.clamp_min(1e-300), 1.0)
        pj = torch.where(bad, unit * d, pj)
        apj = pj.abs()
        ph = ph * torch.where(apj > 0, pj / apj.clamp_min(1e-300), 1.0)
        ld = ld + apj.clamp_min(1e-300).log()
        row = W[:, j, :] / pj[:, None]
        f = W[:, :, j].clone()
        f[:, j] = 0
        W.sub_(f[:, :, None] * row[:, None, :])
        W[:, j, :] = row
    return W[:, :, m:], ld, mp, npert, ph


def _gj_inv(D, delta):
    """Batched Gauss-Jordan inverse of D (w, m, m) with MUMPS-style static
    pivot clamping (no row interchanges; pivots with |p| <= delta are
    replaced by delta * p/|p|, counted and reported —
    interface_cudss.cu:288-351). ``delta`` is a tensor of one value, or
    of one value per matrix of a batch whose pivot blocks are runs of w /
    len(delta) consecutive lanes (``_lane_delta``).

    Returns (Dinv, log|det|, min|pivot|, n_perturbed, phase) per batch
    lane; ``phase`` is the product of pivot signs (sign of the
    determinant; unit-modulus complex phase for complex dtypes). The pivot
    bookkeeping and the order of its sums are the reference package's
    ``_gj_inv``.

    A CPU tensor takes the plain version (``_gj_inv_plain``); a CUDA
    tensor launches ``csrc/gj_inv.cu`` once, which returns the inverse and
    the statistics (float64, 1 <= m <= ``GJ_MAX_M``, rows of a view read in
    place when its last dimension is contiguous; ``delta`` is read on the
    card, so the host does not wait), or raises."""
    if D.device.type == "cpu":
        return _gj_inv_plain(D, delta)
    if D.device.type != "cuda":
        raise ValueError(f"gj_inv: no kernel for {D.device}")
    if D.dtype != torch.float64:
        raise TypeError(f"gj_inv: the kernel takes float64, got {D.dtype}")
    w, m = D.shape[0], D.shape[-1]
    if D.dim() != 3 or D.shape[1] != m or not 1 <= m <= GJ_MAX_M:
        raise ValueError(f"gj_inv: the kernel takes (w, m, m) with "
                         f"1 <= m <= {GJ_MAX_M}, got {tuple(D.shape)}")
    if D.stride(-1) != 1:
        D = D.contiguous()
    d = torch.as_tensor(delta, dtype=torch.float64,
                        device=D.device).reshape(-1).contiguous()
    n_delta = d.numel()
    if n_delta == 0 or w % n_delta:
        raise ValueError(f"gj_inv: {n_delta} pivot thresholds do not split "
                         f"{w} lanes")
    Dinv = torch.empty((w, m, m), dtype=D.dtype, device=D.device)
    ld, mp, ph = (torch.empty(w, dtype=D.dtype, device=D.device)
                  for _ in range(3))
    npert = torch.empty(w, dtype=torch.int32, device=D.device)
    if w:
        fn = _cuda.library("gj_inv").gj_inv_f64
        _cuda.launch_check("gj_inv", fn(
            D.data_ptr(), D.stride(0), D.stride(1), d.data_ptr(), n_delta,
            w, m, Dinv.data_ptr(), ld.data_ptr(), mp.data_ptr(),
            npert.data_ptr(), ph.data_ptr(), _cuda.stream_of(D)))
        _gj_inv.launches += 1
    return Dinv, ld, mp, npert, ph


def _inv_block(D, delta):
    """Batched inverse of (w, m, m) via recursive 2x2 Schur splitting down
    to a Gauss-Jordan base of at most ``GJ_MAX_M`` (the products are
    batched GEMMs). log|det D| = log|det A| + log|det S|. ``delta`` as
    ``_gj_inv`` takes it."""
    m = D.shape[-1]
    if m <= GJ_MAX_M:
        return _gj_inv(D, delta)
    h = m // 2
    A, B = D[:, :h, :h], D[:, :h, h:]
    C, Dd = D[:, h:, :h], D[:, h:, h:]
    Ai, ld1, mp1, np1, ph1 = _inv_block(A, delta)
    AiB = Ai @ B
    CAi = C @ Ai
    S = Dd - C @ AiB
    Si, ld2, mp2, np2, ph2 = _inv_block(S, delta)
    SiCAi = Si @ CAi
    X11 = Ai + AiB @ SiCAi
    X12 = -AiB @ Si
    X21 = -SiCAi
    top = torch.cat([X11, X12], dim=-1)
    bot = torch.cat([X21, Si], dim=-1)
    return (torch.cat([top, bot], dim=-2), ld1 + ld2,
            torch.minimum(mp1, mp2), np1 + np2, ph1 * ph2)


def _init_states(plan: SpluPlan, datas, dp):
    """Assemble entry values into padded block storage. COMPLEX matrices
    are stored as their REAL EMBEDDING K = [[R,-I],[I,R]] per block
    (2b x 2b row-major, flat width 4*b*b): K is closed under add /
    multiply / inverse, so the complex elimination IS the real
    elimination at block size 2b. Storage row ``nblk + TL`` holds an
    IDENTITY block (the U lanes' right-multiplier) and the last row is
    spare, so every row window ``t0 ... t0+TL`` stays inside the storage.
    Each of ``datas`` is (nnz,) or a batch (lanes, nnz). Returns (states,
    deltas, cplxs); a state is [blocks (lanes, N, width), log|det|,
    min|pivot|, n_perturbed, phase], each statistic and each delta
    (lanes,), with one lane for an unbatched matrix."""
    b, nblk = plan.b, plan.nblk
    bb = b * b
    TL = plan.packed["TL"]
    nrow_store = nblk + TL + 1
    states, deltas, cplxs = [], [], []
    for data in datas:
        data = data.reshape(-1, data.shape[-1])
        lanes = data.shape[0]
        cplx = data.is_complex()
        cplxs.append(cplx)
        rdt = data.real.dtype if cplx else data.dtype
        if rdt != torch.float64:
            raise TypeError(f"SPLU factorizes float64/complex128, got "
                            f"{data.dtype}")
        dev = data.device
        # duplicate entries add in entry order, one duplicate rank a pass
        # (no two adds of a pass meet, so no race on the card)
        if cplx:
            flat = torch.zeros((lanes, nrow_store * 4 * bb), dtype=rdt,
                               device=dev)
            flat[:, dp["ones_k"]] = flat.new_ones(())
            for ids, _, (i_re1, i_re2, i_im1, i_im2) in dp["scatter_passes"]:
                d = data.index_select(1, ids)
                dre, dim = d.real, d.imag
                flat.index_add_(1, i_re1, dre)
                flat.index_add_(1, i_re2, dre)
                flat.index_add_(1, i_im1, dim)
                flat.index_add_(1, i_im2, -dim)
            blocks = flat.view(lanes, nrow_store, 4 * bb)
        else:
            flat = torch.zeros((lanes, nrow_store * bb), dtype=rdt,
                               device=dev)
            flat[:, dp["ones_r"]] = flat.new_ones(())
            for ids, pos, _ in dp["scatter_passes"]:
                flat.index_add_(1, pos, data.index_select(1, ids))
            blocks = flat.view(lanes, nrow_store, bb)
        deltas.append(plan.pivot_epsilon * (1.0 + data.abs().amax(-1)))
        states.append([blocks,
                       torch.zeros(lanes, dtype=rdt, device=dev),
                       torch.full((lanes,), float("inf"), dtype=rdt,
                                  device=dev),
                       torch.zeros(lanes, dtype=torch.int32, device=dev),
                       torch.ones(lanes, dtype=rdt, device=dev)])
    return states, deltas, cplxs


def _scan_packed(plan: SpluPlan, states, deltas, cplxs, dp, pairs=None,
                 reduce=None):
    """Run the packed left-looking elimination over the schedule rows.
    Per row and state: subtract the segment-summed pair products
    (``splu_pairs``), invert the diagonal lanes (a row PREFIX of ``nd``
    lanes), right-multiply every other live lane by its per-lane block —
    the freshly inverted in-row diagonal for L lanes of MERGED rows, the
    stored Dinv for L lanes of split panel rows, the identity slot for U
    lanes (``gather_rows``) — and write the row's live range back. A
    state carries every matrix of its batch: one launch of each kernel a
    row, whatever the batch.

    Where the reference package's ``lax.scan`` writes the row window with
    ``dynamic_update_slice`` and masks dead lanes, this loop writes the
    live range ``blocks[:, t0:t0+len]`` in place: ``len`` and ``nd`` are
    host ints. The states are updated in place.

    With ``pairs`` (``_rank_pairs``) each row sums only this rank's share
    of its pairs, and ``reduce`` (an all-reduce over the ranks) makes the
    sum whole before the rest of the row, which every rank runs alike: the
    reference package's ``psum_axis``."""
    b = plan.b
    for r, (t0, ln, nd, npair, has_fresh, _, _) in enumerate(dp["rows"]):
        p0, p1, work_r = ((0, npair, dp["work"][r]) if pairs is None
                          else pairs[r])
        pl_r = dp["pair_l"][r, p0:p1]
        pu_r = dp["pair_u"][r, p0:p1]
        ps_r = dp["pair_seg"][r, p0:p1]
        dinv_r = dp["dinv"][r, :ln]
        for st, delta, cplx in zip(states, deltas, cplxs):
            blocks = st[0]
            lanes, width = blocks.shape[0], blocks.shape[2]
            be = 2 * b if cplx else b
            acc = splu_pairs(blocks, pl_r, pu_r, ps_r, work_r, ln, be)
            if reduce is not None:
                acc = reduce(acc)
            vals = (blocks[:, t0:t0 + ln] - acc).view(lanes, ln, be, be)
            Dv = gather_rows(blocks, dinv_r).view(lanes, ln, be, be)
            if nd:
                Dinv, ldw, mpw, npw, phw = _inv_block(
                    vals[:, :nd].reshape(lanes * nd, be, be), delta)
                Dinv = Dinv.view(lanes, nd, be, be)
                if has_fresh:
                    eye = torch.eye(be, dtype=blocks.dtype,
                                    device=blocks.device)
                    Dtab = torch.cat([Dinv, eye.expand(lanes, 1, be, be)],
                                     dim=1)
                    Dl = Dtab[:, dp["dloc"][r, :ln]]
                    Dv = torch.where(dp["fresh"][r, :ln, None, None], Dl, Dv)
                blocks[:, t0:t0 + nd] = Dinv.reshape(lanes, nd, width)
                if ln > nd:
                    pan = torch.matmul(vals[:, nd:], Dv[:, nd:])
                    blocks[:, t0 + nd:t0 + ln] = pan.view(lanes, ln - nd,
                                                          width)
                ldd = ldw.view(lanes, nd).sum(-1)
                if cplx:
                    # K embedding: det K = |det M|^2 -> halve log|det|;
                    # the complex phase of det M is not recoverable here
                    st[1].add_(0.5 * ldd)
                else:
                    st[1].add_(ldd)
                    st[4].mul_(phw.view(lanes, nd).prod(-1))
                torch.minimum(st[2], mpw.view(lanes, nd).amin(-1),
                              out=st[2])
                st[3].add_(npw.view(lanes, nd).sum(-1, dtype=torch.int32))
            else:
                pan = torch.matmul(vals, Dv)
                blocks[:, t0:t0 + ln] = pan.view(lanes, ln, width)
    return states


def _fac_dict(state, batched: bool):
    """A factorization's dict from its state; an unbatched matrix's
    without the lane dimension."""
    blocks, ld, mp, npert, ph = (t if batched else t[0] for t in state)
    return {"blocks": blocks, "logdet": ld, "phase": ph, "min_pivot": mp,
            "n_perturbed": npert}


def splu_factorize(plan: SpluPlan, data):
    """Numeric block elimination over the PACKED schedule; ``data`` are the
    entry values (f64 or complex128 tensor) in the original entry order,
    on the device the factorization runs on: (nnz,), or (B, nnz) for B
    matrices at once."""
    return splu_factorize_multi(plan, (data,))[0]


def splu_factorize_multi(plan: SpluPlan, datas):
    """Factorize SEVERAL matrices with the same sparsity in ONE pass over
    the packed schedule (the Radau5 real/complex pair shares every row's
    fixed cost). Returns one dict per matrix: ``blocks`` (K-embedding
    layout iff complex), ``logdet``, ``phase`` (the determinant sign for
    REAL matrices, 1 for complex ones), ``min_pivot``, ``n_perturbed``.
    Each of ``datas`` may be a batch (B, nnz): its dict then holds blocks
    (B, N, width) and (B,) statistics."""
    dp = _device_plan(plan, datas[0].device)
    states, deltas, cplxs = _init_states(plan, datas, dp)
    states = _scan_packed(plan, states, deltas, cplxs, dp)
    return [_fac_dict(st, data.dim() > 1) for st, data in zip(states, datas)]


def splu_det_phase(plan: SpluPlan, fac):
    """The COMPLEX determinant phase of a factorization, as a (2,) float64
    tensor (re, im) on the factors' device (the reference package's
    ``splu_det_phase``; MUMPS ICNTL(33) full complex determinant).

    A real layout's phase is the exact sign the factorization tracked. A
    K-embedded one stores each diagonal block as the embedding of the
    complex INVERSE pivot block Minv_k; the symmetric fill-reducing
    permutation has sign^2 = 1 and static pivoting swaps no rows, so
    phase(det A) = conj(prod_k phase(det Minv_k)), each from
    ``torch.linalg.slogdet`` of Minv_k = R + i I in complex128."""
    b = plan.b
    bl = fac["blocks"]
    if bl.shape[1] != 4 * b * b:          # real layout: phase is exact
        return torch.stack([fac["phase"].to(bl.dtype),
                            torch.zeros((), dtype=bl.dtype,
                                        device=bl.device)])
    b2 = 2 * b
    dp = _device_plan(plan, bl.device)
    D = bl[dp["diag_g"][:-1]].view(-1, b2, b2)
    M = torch.complex(D[:, :b, :b], D[:, b:, :b])
    tot = torch.linalg.slogdet(M).sign.prod().conj()
    return torch.stack([tot.real, tot.imag])


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------


def splu_solve(plan: SpluPlan, fac, bvec):
    """x = A^{-1} b via packed block substitution.

    Forward: z_k = b_k - sum_{j<k} Lhat_kj z_j (tree levels ascending).
    Backward: x_k = Dinv_k (z_k - sum_{j>k} A_kj x_j) (descending)."""
    return splu_solve_multi(plan, (fac,), (bvec,))[0]


def splu_solve_multi(plan: SpluPlan, facs, bvecs):
    """Solve SEVERAL systems (their own factors and right-hand sides, same
    plan) in ONE pass over the substitution rows. Complex systems run on
    the real K embedding: the substitution is the real one at width 2b on
    stacked [re; im] vector blocks. The factors of a batch (blocks (B, N,
    width)) take right-hand sides (B, n), one lane each."""
    b, nb = plan.b, plan.nb
    bb = b * b
    dev = facs[0]["blocks"].device
    dp = _device_plan(plan, dev)
    perm = dp["perm"]

    blks, cplxs, bps, batched = [], [], [], []
    for fac, bvec in zip(facs, bvecs):
        bl = fac["blocks"]
        batched.append(bl.dim() == 3)
        bl = bl.view((-1,) + bl.shape[-2:])
        bvec = bvec.reshape(-1, bvec.shape[-1])
        lanes = bl.shape[0]
        cplx = bl.shape[-1] == 4 * bb   # K-embedding layout
        blks.append(bl)
        cplxs.append(cplx)
        if cplx:
            bpr = torch.zeros((lanes, nb * b), dtype=bl.dtype, device=dev)
            bpi = torch.zeros((lanes, nb * b), dtype=bl.dtype, device=dev)
            bpr[:, perm] = bvec.real.to(bl.dtype)
            bpi[:, perm] = bvec.imag.to(bl.dtype)
            bp = torch.stack([bpr.view(lanes, nb, b),
                              bpi.view(lanes, nb, b)],
                             dim=2).reshape(lanes, nb, 2 * b)
        else:
            bp = torch.zeros((lanes, nb * b), dtype=bl.dtype, device=dev)
            bp[:, perm] = bvec.to(bl.dtype)
            bp = bp.view(lanes, nb, b)
        bps.append(bp)

    def run(sched, rhs_list, apply_dinv):
        vs = [torch.zeros((bl.shape[0], nb, (2 if c else 1) * b),
                          dtype=bl.dtype, device=dev)
              for bl, c in zip(blks, cplxs)]
        for r, (n_src, n_tgt) in enumerate(sched["rows"]):
            tgt = sched["tgt"][r, :n_tgt]
            src = sched["src"][r, :n_src]
            col = sched["col"][r, :n_src]
            order, offsets = sched["sums"][r]
            for v, bl, rhs, cplx in zip(vs, blks, rhs_list, cplxs):
                lanes = bl.shape[0]
                be = 2 * b if cplx else b
                rr = rhs[:, tgt]
                if n_src:
                    S = bl[:, src].view(lanes * n_src, be, be)
                    vc = v[:, col].reshape(lanes * n_src, be, 1)
                    prod = torch.bmm(S, vc).view(lanes, n_src, be)
                    rr = rr - segment_sum(prod.transpose(0, 1), order,
                                          offsets).transpose(0, 1)
                if apply_dinv:
                    Dv = bl[:, dp["diag_g"][tgt]].view(lanes * n_tgt, be,
                                                       be)
                    rr = torch.bmm(Dv, rr.reshape(lanes * n_tgt, be, 1)
                                   ).view(lanes, n_tgt, be)
                v[:, tgt] = rr
        return vs

    zs = run(dp["fwd"], bps, False)
    xs_out = run(dp["bwd"], zs, True)
    outs = []
    for x, cplx, bat in zip(xs_out, cplxs, batched):
        lanes = x.shape[0]
        if cplx:
            v = x.view(lanes, nb, 2, b)
            x = torch.complex(v[:, :, 0], v[:, :, 1])
        x = x.reshape(lanes, nb * b)[:, perm]
        outs.append(x if bat else x[0])
    return outs


reset_launch_counts()
