"""Regular-grid nested-dissection multifrontal solver (GRIDMF) in PyTorch.

Counterpart of ``russell_tpu.sparse.gridmf``: the solver the reference
package routes grid-hinted systems to by default (``factor.analyze`` with
``Genie.AUTO`` and a ``grid`` hint), for matrices whose graph is a 2-D or
3-D box of cells, ``s`` unknowns a cell, stencil reach <= 1 cell (the
Brusselator PDE Jacobian, the 2-D/3-D Laplacians).

- **symbolic (host, numpy)**: recursive bisection of the grid by
  1-cell-thick separator hyperplanes, each axis padded to the smallest
  perfectly splittable size ``P = 2^a (leaf+1) - 1``, so every node of a
  tree depth is congruent: one front layout and one child->parent
  embedding per (depth, side). Front layouts are union-trimmed (an
  offset is kept only if it lands in the real grid for some node of the
  depth). This part is copied from the reference package, so both build
  equal plans (every array equal).
- **numeric (device)**: per depth, from the leaves up, one batched dense
  pipeline: assemble the fronts (one scatter of pre-summed entry values,
  a unit diagonal in every ghost pivot slot), extend-add the children's
  Schur complements (two gathers through constant maps per side), invert
  the pivot block with ``splu._inv_block`` (recursive Schur splitting down
  to the clamped Gauss-Jordan base, the ``gj_inv`` CUDA kernel on the
  card), then the panel and Schur products as batched matmuls.
- **solve (device)**: an up-sweep of the right-hand side through the
  stored panels, then a down-sweep of back-substitution; batched
  matrix-vector products with gathers and scatters.
- **out of core** (``gridmf_factorize_ooc``, ``gridmf_solve_ooc``): when
  the factors exceed the device budget (``factor.GRIDMF_BUDGET_GB``), each
  depth's factors go to pinned host memory as they are made, a node chunk
  at a time, and the solve ships each level back when it needs it, the
  next one on a side stream while the current one computes.

Complex systems are carried as real and imaginary planes end to end,
with 3-multiplication (Karatsuba) products, and the pivot block is
inverted through its real embedding K = [[R, -I], [I, R]], as in the
reference package: the factors compare element by element with its, and
the inverse is one real kernel. log|det| is exact; the complex phase is
not recoverable from K (phase = 1), the reference's contract.

Every index array the numeric phase reads is uploaded once per (plan,
device) (``_device_plan``); no factorize or solve uploads an index.
"""

from __future__ import annotations

import math
import mmap
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from russell_tpu_torch.sparse.ordering import idx32 as _idx32, rank_passes
from russell_tpu_torch.sparse.splu import _inv_block

__all__ = ["GridMfPlan", "HostLevels", "gridmf_analyze", "gridmf_factorize",
           "gridmf_solve", "gridmf_factorize_ooc", "gridmf_solve_ooc",
           "gridmf_flops", "gridmf_store_gb"]

# Out of core: a depth whose fronts take more than GRIDMF_CHUNK_GB GiB is
# assembled and factorized a node chunk of at most that size at a time, its
# children's Schur complements read back from host memory chunk by chunk;
# a smaller depth is assembled whole and factorized in node chunks of about
# GRIDMF_STEP_GB GiB of fronts (the reference package's 2.0, from
# RUSSELL_TPU_GRIDMF_CHUNK_GB, and 1.5). Tests patch these attributes.
GRIDMF_CHUNK_GB = 2.0
GRIDMF_STEP_GB = 1.5


# ---------------------------------------------------------------------------
# host symbolic phase
# ---------------------------------------------------------------------------


@dataclass
class _Level:
    """Static description of one congruent tree depth (host arrays)."""

    n_nodes: int
    ncell_front: int      # front cells (elim cells first, then shell)
    ncell_elim: int
    s: int                # vars per cell
    # entry assembly: unique flat positions into (n_nodes*F*F) and the
    # slice of the global pre-summed value array feeding them
    asm_idx: np.ndarray = None
    asm_off: int = 0
    asm_len: int = 0
    ghost_diag: np.ndarray = None        # flat positions getting +1.0
    elim_var: np.ndarray = None          # (n_nodes, e) global var or n (pad)
    # child->parent embedding: for each child keep position, the parent
    # front position (or -1 = dropped ghost overflow); one map per side
    emb: Optional[np.ndarray] = None     # (2, r_child_vars) into parent F

    @property
    def F(self):
        return self.ncell_front * self.s

    @property
    def e(self):
        return self.ncell_elim * self.s

    @property
    def r(self):
        return self.F - self.e


@dataclass
class GridMfPlan:
    """Symbolic output: congruent per-depth schedules, leaf level last
    in ``levels`` (device factorize iterates levels in REVERSE —
    elimination order, leaves first)."""

    n: int
    dims: Tuple[int, ...]   # real grid extents per axis (2-D or 3-D)
    s: int
    levels: List[_Level] = field(default_factory=list)  # depth 0 = root
    entry_perm: np.ndarray = None   # entries ordered by (depth, position)
    entry_seg: np.ndarray = None    # segment id per permuted entry
    n_uniq: int = 0
    pivot_epsilon: float = 1e-14


def _box_offsets(shape):
    """Row-major (dr, dc, ...) offsets of every cell in a box."""
    grids = np.meshgrid(*[np.arange(int(d)) for d in shape], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1).astype(np.int64)


def _elim_offsets(shape, axis, m, leaf):
    """Eliminated cells of a node: the whole box (leaf) or the
    1-cell-thick separator hyperplane at position ``m`` on ``axis``."""
    if leaf:
        return _box_offsets(shape)
    sub = list(shape)
    sub[axis] = 1
    off = _box_offsets(sub)
    off[:, axis] = m
    return off


def _shell_offsets(shape):
    """Chebyshev-distance-1 exterior cells of the box (the coupling set
    of its boundary under reach-1 stencils), row-major enumeration."""
    shape = np.asarray(shape, dtype=np.int64)
    infl = _box_offsets(shape + 2) - 1
    outside = np.any((infl < 0) | (infl >= shape[None, :]), axis=1)
    return infl[outside]


def _pad_axis(nreal: int, target: int):
    """Smallest perfectly-splittable virtual size ``P = 2^a*(l+1) - 1``
    covering ``nreal``, over leaf lengths ``l`` near ``target`` (minimal
    padding first, larger leaves on ties). A no-split axis (P = l =
    nreal) is only allowed when the axis already fits within the leaf
    range. Returns (P, l)."""
    best = None
    for l in range(2, max(2 * target, target + 8) + 1):
        if nreal <= l:
            cand = (nreal, nreal)
        else:
            a = 1
            while ((l + 1) << a) - 1 < nreal:
                a += 1
            cand = (((l + 1) << a) - 1, l)
        if best is None or (cand[0], -cand[1]) < (best[0], -best[1]):
            best = cand
    return best


def gridmf_analyze(n: int, rows, cols, grid,
                   leaf_cells: int = 32,
                   pivot_epsilon: float = 1e-14) -> GridMfPlan:
    """Symbolic phase. ``grid`` = (*dims, s) — 2-D ``(nr, nc, s)`` or
    3-D ``(n0, n1, n2, s)`` — with the species-major variable layout
    ``var = k*prod(dims) + row_major_cell`` (the natural layout of
    russell_tpu.ode.samples.brusselator_pde, pde.fdm and
    sparse.samples.laplacian_2d/3d). Raises ValueError if the entry
    pattern is not cell-local (stencil reach must be <= 1 cell in each
    direction; periodic wrap is rejected)."""
    grid = tuple(int(v) for v in grid)
    if len(grid) < 3:
        raise ValueError("grid hint must be (*dims, s) with >= 2 axes")
    dims, s = grid[:-1], grid[-1]
    k = len(dims)
    if any(d < 2 for d in dims):
        raise ValueError("gridmf needs every grid axis >= 2")
    ncell = int(np.prod(dims))
    if ncell * s != n:
        raise ValueError(f"grid {grid} does not cover n={n}")
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    dims_arr = np.asarray(dims, dtype=np.int64)
    strides = np.ones(k, dtype=np.int64)
    for a in range(k - 2, -1, -1):
        strides[a] = strides[a + 1] * dims[a + 1]

    ci_cell = rows % ncell
    cj_cell = cols % ncell
    for a in range(k):
        da = ((cj_cell // strides[a]) % dims[a]
              - (ci_cell // strides[a]) % dims[a])
        if len(da) and np.max(np.abs(da)) > 1:
            raise ValueError("entry pattern is not cell-local "
                             "(stencil reach > 1 or periodic wrap)")

    # ---- perfectly-splittable virtual grid + shapes per depth -------------
    # Each axis padded to P = 2^a*(l+1)-1 so every bisection is exact
    # (h = 2m+1 -> both children exactly m): all nodes at a depth are
    # congruent and every ghost cell lies beyond the real high edge,
    # where it can never coincide with a real cell of another node.
    t = max(2, int(round(leaf_cells ** (1.0 / k))))
    pads = [_pad_axis(d, t) for d in dims]
    cur = [p for p, _ in pads]
    leaf_len = [l for _, l in pads]
    shapes = []
    while (int(np.prod(cur)) > leaf_cells
           and any(cur[a] > leaf_len[a] for a in range(k))):
        cand = [a for a in range(k) if cur[a] > leaf_len[a]]
        axis = min(cand, key=lambda a: (-cur[a], a))
        m = cur[axis] // 2
        shapes.append((tuple(cur), axis, m, False))
        cur[axis] = m
    shapes.append((tuple(cur), 0, 0, True))
    D = len(shapes) - 1   # leaf depth

    # ---- per-node origins (children interleaved as 2i, 2i+1) --------------
    origins = [np.zeros((1, k), dtype=np.int64)]
    for d in range(D):
        _shape, axis, m, _ = shapes[d]
        org = origins[d]
        o_hi = org.copy()
        o_hi[:, axis] += m + 1
        origins.append(np.stack([org, o_hi], axis=1).reshape(-1, k))

    # ---- per-depth union-trimmed layouts + cell painting -------------------
    depth_of = np.full(ncell, -1, dtype=np.int64)
    node_of = np.full(ncell, -1, dtype=np.int64)
    levels: List[_Level] = []
    luts: List[np.ndarray] = []
    soffs: List[np.ndarray] = []
    for d in range(D + 1):
        shape, axis, m, leaf = shapes[d]
        org = origins[d]
        # union trim: offset o admissible on axis a iff org_a + o_a lands
        # in the real grid for SOME node (origins form a per-axis product,
        # so the any-node test factorizes per axis)
        adm = []
        for a in range(k):
            o = np.arange(-1, shape[a] + 1)
            u = np.unique(org[:, a])
            ok = ((u[None, :] + o[:, None] >= 0)
                  & (u[None, :] + o[:, None] < dims_arr[a])).any(axis=1)
            adm.append(ok)

        def _keep(off):
            kp = np.ones(len(off), dtype=bool)
            for a in range(k):
                kp &= adm[a][off[:, a] + 1]
            return off[kp]

        eoff = _keep(_elim_offsets(shape, axis, m, leaf))
        if len(eoff) == 0:
            # pathological padding: an all-ghost separator — keep one
            # slot so the pivot block is non-empty (unit pivot, det 0)
            eoff = _elim_offsets(shape, axis, m, leaf)[:1]
        soff = _keep(_shell_offsets(shape))
        lut = np.full(tuple(dd + 2 for dd in shape), -1, dtype=np.int64)
        lut[tuple((eoff + 1).T)] = np.arange(len(eoff))
        lut[tuple((soff + 1).T)] = len(eoff) + np.arange(len(soff))
        luts.append(lut)
        soffs.append(soff)

        lv = _Level(n_nodes=len(org),
                    ncell_front=len(eoff) + len(soff),
                    ncell_elim=len(eoff), s=s)
        levels.append(lv)
        g = org[:, None, :] + eoff[None, :, :]         # (n_nodes, ne, k)
        realmask = np.all(g < dims_arr[None, None, :], axis=2)
        flatcell = (g * strides[None, None, :]).sum(axis=2)
        rr = flatcell[realmask]
        assert np.all(depth_of[rr] == -1), "cell painted twice"
        depth_of[rr] = d
        node_of[rr] = np.broadcast_to(
            np.arange(len(org))[:, None], flatcell.shape)[realmask]
        # elim var ids (ghost -> n pad), species-major layout
        evar = (flatcell[:, :, None]
                + np.arange(s)[None, None, :] * ncell)
        evar = np.where(realmask[:, :, None], evar, n)
        lv.elim_var = evar.reshape(len(org), -1).astype(np.int32)
        # ghost diagonal positions (per VAR)
        gmask = ~realmask
        if gmask.any():
            nidx, eidx = np.nonzero(gmask)
            F = lv.F
            base = (nidx[:, None] * F + (eidx[:, None] * s
                                         + np.arange(s)[None, :]))
            lv.ghost_diag = (base * F + (eidx[:, None] * s
                                         + np.arange(s)[None, :])
                             ).reshape(-1).astype(np.int64)
        else:
            lv.ghost_diag = np.zeros(0, dtype=np.int64)
    assert np.all(depth_of >= 0)

    # ---- child->parent embedding maps (per depth, per side) --------------
    for d in range(1, D + 1):
        _pshape, p_axis, p_m, _p_leaf = shapes[d - 1]
        soff = soffs[d]
        plut = luts[d - 1]
        emb = np.empty((2, len(soff) * s), dtype=np.int64)
        for side in (0, 1):
            poff = soff.copy()
            poff[:, p_axis] += (p_m + 1) * side
            cpos = plut[tuple((poff + 1).T)]
            vpos = np.where(cpos[:, None] >= 0,
                            cpos[:, None] * s + np.arange(s)[None, :], -1)
            emb[side] = vpos.reshape(-1)
        levels[d].emb = emb

    # ---- entry assembly ---------------------------------------------------
    ki = rows // ncell
    kj = cols // ncell
    di = depth_of[ci_cell]
    dj = depth_of[cj_cell]
    dh = np.maximum(di, dj)           # deeper endpoint = home depth
    home_cell = np.where(di >= dj, ci_cell, cj_cell)
    nid = node_of[home_cell]

    def pos_in_home(cell, kk):
        pos = np.empty(len(rows), dtype=np.int64)
        coords = np.stack([(cell // strides[a]) % dims[a]
                           for a in range(k)], axis=1)
        for d in range(D + 1):
            sel = dh == d
            if not sel.any():
                continue
            off = coords[sel] - origins[d][nid[sel]]
            p = luts[d][tuple((off + 1).T)]
            assert np.all(p >= 0), "entry endpoint outside home front"
            pos[sel] = p * s + kk[sel]
        return pos

    pi = pos_in_home(ci_cell, ki)
    pj = pos_in_home(cj_cell, kj)
    # flat position within the depth's (n_nodes, F, F) front array
    Fs = np.array([lv.F for lv in levels], dtype=np.int64)
    flat = (nid * Fs[dh] + pi) * Fs[dh] + pj
    key = dh * (np.max(flat) + 2) + flat  # order by depth, then position
    order = np.argsort(key, kind="stable")
    uk, seg = np.unique(key[order], return_inverse=True)
    plan = GridMfPlan(n=n, dims=dims, s=s, levels=levels,
                      entry_perm=order.astype(np.int64),
                      entry_seg=seg.astype(np.int64), n_uniq=len(uk),
                      pivot_epsilon=pivot_epsilon)
    # per-depth unique positions + value slices
    ud = uk // (np.max(flat) + 2)
    uflat = uk % (np.max(flat) + 2)
    for d in range(D + 1):
        sel = ud == d
        levels[d].asm_idx = uflat[sel].astype(np.int64)
        levels[d].asm_off = int(np.searchsorted(ud, d, side="left"))
        levels[d].asm_len = int(sel.sum())
    return plan


# ---------------------------------------------------------------------------
# device numeric phase
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# index arrays on the device
# ---------------------------------------------------------------------------


def _inv_embed(parent_F: int, child: _Level, side: int, pad: int):
    """inv[parent front pos] = child keep pos (or ``pad`` = zero slot)."""
    inv = np.full(parent_F, pad, dtype=np.int64)
    m = child.emb[side]
    src = np.nonzero(m >= 0)[0]
    inv[m[m >= 0]] = src
    return inv


def _device_plan(plan: GridMfPlan, device):
    """Every index array of the numeric phase on ``device`` (int32 where
    it fits, ``idx32``), uploaded once per (plan, device) and kept on the
    plan: ``presum``, the passes of ``_presum``; per depth d: ``asm`` /
    ``gd`` (the assembly and ghost-diagonal positions in the depth's flat
    fronts), ``ev`` (elim vars, ghosts -> n),
    and for d > 0 ``restrict`` (both sides' child keep positions in the
    parent front, ghosts -> the parent's zero pad slot) and, on depth d - 1,
    ``inv`` (per side, the parent front's child keep position, or the
    child's zero pad slot r)."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    dp = cache.get(key)
    if dp is not None:
        return dp

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(_idx32(a)),
                               device=device)

    levels = []
    for d, lv in enumerate(plan.levels):
        ent = {"asm": t(lv.asm_idx), "gd": t(lv.ghost_diag),
               "ev": t(lv.elim_var.reshape(-1))}
        if d > 0:
            m = lv.emb.copy()          # never write into the plan's array
            m[m < 0] = plan.levels[d - 1].F
            ent["restrict"] = t(m.reshape(-1))
        if d + 1 < len(plan.levels):
            child = plan.levels[d + 1]
            ent["inv"] = tuple(t(_inv_embed(lv.F, child, side, child.r))
                               for side in (0, 1))
        levels.append(ent)
    # the pre-sum's passes: pass k takes the k-th entry of every unique
    # position that has more than k
    seg = plan.entry_seg
    presum = [(t(plan.entry_perm[ids]), t(seg[ids]))
              for ids in rank_passes(seg)]
    dp = cache[key] = {"presum": presum, "levels": levels}
    return dp


# ---------------------------------------------------------------------------
# device numeric phase
# ---------------------------------------------------------------------------


def _presum(plan: GridMfPlan, dp, data):
    """Duplicate entries collapse onto their unique front positions,
    summed in entry order: one gather and one index_add per duplicate
    rank, each over distinct positions, so no two adds to one address
    race on the card and every run gives the same bits (the Brusselator's
    diagonal has three entries: Jacobian, Laplacian centre, mass). ``data``
    (lanes, nnz) gives (lanes, n_uniq)."""
    out = torch.zeros((data.shape[0], plan.n_uniq), dtype=data.dtype,
                      device=data.device)
    for perm, seg in dp["presum"]:
        out.index_add_(1, seg, data.index_select(1, perm))
    return out


def _node_block(cache, n_nodes, F, gd, asm, asm_off, ev, rng):
    """The assembly of nodes [a, b) = ``rng`` of one depth (GRIDMF) or
    class (GENMF), rebased to the block: {"n": b - a, "gd": ghost-diagonal
    positions, "asm": entry positions, "src": their pre-summed values'
    ids, "ev": the block's elim vars}, from the host arrays ``gd`` and
    ``asm`` (flat positions in the (n_nodes, F, F) fronts, pre-summed
    values from ``asm_off``) and the depth's elim vars ``ev`` on the
    device. None for no range or the whole depth. Built once per block
    and kept in ``cache``, the depth's entry of the device plan."""
    if rng is None or rng == (0, n_nodes):
        return None
    blk = cache.get(rng)
    if blk is not None:
        return blk
    a, b = rng
    dev = ev.device
    e = ev.numel() // n_nodes
    lo, hi = a * F * F, b * F * F

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(_idx32(x)), device=dev)

    in_gd = (gd >= lo) & (gd < hi)
    in_asm = (asm >= lo) & (asm < hi)
    blk = cache[rng] = {"n": b - a, "gd": t(gd[in_gd] - lo),
                        "asm": t(asm[in_asm] - lo),
                        "src": t(asm_off + np.flatnonzero(in_asm)),
                        "ev": ev[a * e:b * e]}
    return blk


def _assemble(lv: _Level, dl, uniq, ghost=True, blk=None):
    """The depth's fronts (lanes * n_nodes, F, F), lane-major, from the
    pre-summed values (lanes, n_uniq); with ``ghost``, a unit diagonal in
    every ghost pivot slot (the REAL plane only, so each contributes
    exactly 0 to log|det|). Every position is written once: the ghost and
    entry positions are unique and apart. With ``blk`` (``_node_block``)
    only that block of nodes."""
    F = lv.F
    lanes = uniq.shape[0]
    n_nodes = lv.n_nodes if blk is None else blk["n"]
    gd = dl["gd"] if blk is None else blk["gd"]
    flat = torch.zeros((lanes, n_nodes * F * F), dtype=uniq.dtype,
                       device=uniq.device)
    if ghost and gd.numel():
        # a device scalar: a Python one is copied from the host
        flat[:, gd] = flat.new_ones(())
    if blk is None:
        if lv.asm_len:
            flat[:, dl["asm"]] = uniq[:, lv.asm_off:lv.asm_off + lv.asm_len]
    elif blk["asm"].numel():
        flat[:, blk["asm"]] = uniq.index_select(1, blk["src"])
    return flat.view(lanes * n_nodes, F, F)


def _regroup(split, child_rng, rng, planes):
    """Carry a child depth's per-node rows (Schur complements, keep
    right-hand sides) into the parent's layout: all-gathered where the
    children were split over the ranks and the parent is not; cut to the
    parent block's children [2a, 2b) where only the parent is split."""
    if child_rng is not None and rng is None:
        return [None if p is None else split.gather(p) for p in planes]
    if child_rng is None and rng is not None:
        a, b = rng
        return [None if p is None else p[2 * a:2 * b] for p in planes]
    return planes


def _combine(split, rng, ld, mp, npc, ph):
    """A split depth's statistics over all ranks (``split.combine``); a
    replicated depth's as they are."""
    if rng is None:
        return ld, mp, npc, ph
    s = split.combine(logdet=ld, min_pivot=mp, n_perturbed=npc, phase=ph)
    return s["logdet"], s["min_pivot"], s["n_perturbed"], s["phase"]


def _embed_mat(parent_dl, schur_re, schur_im):
    """Extend-add both children's Schur complements into zero-initialised
    parent fronts: T[n, a, b] = Sch[n, side, inv[a], inv[b]] as two gathers
    with constant index vectors per side (ghost overflow positions read a
    zero pad slot). Lane-major fronts of a batch keep their lanes apart:
    each lane's node count at a depth is even, so its children pair up
    within the lane."""
    r = schur_re.shape[-1]
    outs = []
    for S in (schur_re, schur_im):
        if S is None:
            outs.append(None)
            continue
        Sp = S.view(S.shape[0] // 2, 2, r, r)
        acc = None
        for side, inv in enumerate(parent_dl["inv"]):
            Spad = tnf.pad(Sp[:, side], (0, 1, 0, 1))
            g = Spad.index_select(1, inv).index_select(2, inv)
            acc = g if acc is None else acc + g
        outs.append(acc)
    return outs


def _embed_vec(parent_dl, fk_re, fk_im):
    outs = []
    for v in (fk_re, fk_im):
        if v is None:
            outs.append(None)
            continue
        r = v.shape[-1]
        vp = v.view(v.shape[0] // 2, 2, r)
        acc = None
        for side, inv in enumerate(parent_dl["inv"]):
            g = tnf.pad(vp[:, side], (0, 1)).index_select(1, inv)
            acc = g if acc is None else acc + g
        outs.append(acc)
    return outs


def _restrict_vec(lv: _Level, dl, xf_re, xf_im):
    """Down-sweep: child keep values from the parent's front solution."""
    r = lv.emb.shape[1]
    outs = []
    for xf in (xf_re, xf_im):
        if xf is None:
            outs.append(None)
            continue
        g = tnf.pad(xf, (0, 1)).index_select(1, dl["restrict"])
        outs.append(g.view(-1, r))
    return outs


def _mm(Ar, Ai, Br, Bi):
    """Planes matmul (3-mult Karatsuba for complex x complex)."""
    if Ai is None and Bi is None:
        return Ar @ Br, None
    if Ai is None:
        return Ar @ Br, Ar @ Bi
    if Bi is None:
        return Ar @ Br, Ai @ Br
    P1 = Ar @ Br
    P2 = Ai @ Bi
    P3 = (Ar + Ai) @ (Br + Bi)
    return P1 - P2, P3 - P1 - P2


def _inv_planes(Sr, Si, delta):
    """Planes inverse via the real embedding K=[[R,-I],[I,R]] and
    splu._inv_block (static pivot clamping). For complex inputs the
    K determinant is |det|^2 -> halve log|det|, phase unrecoverable.
    ``delta`` (lanes,) holds each matrix's pivot threshold, the fronts
    being lanes runs of as many fronts; the statistics are each lane's
    (lanes,), reduced over its fronts."""
    lanes = delta.numel()
    if Si is None:
        Dinv, ld, mp, npc, ph = _inv_block(Sr, delta)
        return (Dinv.contiguous(), None, ld.view(lanes, -1).sum(-1),
                mp.view(lanes, -1).amin(-1),
                npc.view(lanes, -1).sum(-1, dtype=torch.int32),
                ph.view(lanes, -1).prod(-1))
    e = Sr.shape[-1]
    K = torch.cat([torch.cat([Sr, -Si], dim=-1),
                   torch.cat([Si, Sr], dim=-1)], dim=-2)
    Kinv, ld, mp, npc, _ = _inv_block(K, delta)
    return (Kinv[:, :e, :e].contiguous(), Kinv[:, e:, :e].contiguous(),
            0.5 * ld.view(lanes, -1).sum(-1), mp.view(lanes, -1).amin(-1),
            npc.view(lanes, -1).sum(-1, dtype=torch.int32),
            torch.ones(lanes, dtype=Sr.dtype, device=Sr.device))


def _block(plan: GridMfPlan, dp, d, rng):
    lv = plan.levels[d]
    dl = dp["levels"][d]
    return _node_block(dl.setdefault("blocks", {}), lv.n_nodes, lv.F,
                       lv.ghost_diag, lv.asm_idx, lv.asm_off, dl["ev"], rng)


def gridmf_factorize(plan: GridMfPlan, data, split=None):
    """Batched multifrontal factorization of the entry values ``data`` (an
    f64 or complex128 tensor on the device to factorize on, in the plan's
    entry order). Returns a fac dict with per-depth ``levels[d]`` =
    {sir, sii, lr, li, br, bi} (planes; the imaginary ones None for a real
    matrix) plus logdet / phase / min_pivot / n_perturbed (0-dim tensors;
    phase is the determinant's sign for real matrices, 1 for complex).

    ``split`` (``parallel.mesh.MeshAxis``) spreads the depths over ranks:
    at a depth whose node count it divides (``split.block``), this rank
    assembles, inverts and updates only its node block [a, b), whose
    children [2a, 2b) are its own, so the extend-add moves nothing; at
    the first depth going up that it does not divide, the children's
    Schur complements are all-gathered and the rest runs on every rank.
    A split depth's statistics are summed over the ranks in rank order
    (``split.combine``). The fac then holds each depth's block and, in
    ``ranges``, each depth's node range (None: every node).

    ``data`` (B, nnz) factorizes B matrices at once: each depth's fronts
    are (B * n_nodes, ...), lane-major, so one launch of each operation
    (and of ``gj_inv``, with one pivot threshold per matrix) serves every
    matrix, and the statistics are (B,). A batch takes no ``split``."""
    cplx, rdt, batched, data = _lane_data("GRIDMF", data, split)
    lanes = data.shape[0]
    dev = data.device
    dp = _device_plan(plan, dev)
    if cplx:
        uniq_re = _presum(plan, dp, data.real)
        uniq_im = _presum(plan, dp, data.imag)
    else:
        uniq_re = _presum(plan, dp, data)
        uniq_im = None
    delta = plan.pivot_epsilon * (1.0 + data.abs().amax(-1))

    store = [None] * len(plan.levels)
    ranges = [None] * len(plan.levels)
    sch_re = sch_im = None
    ld = torch.zeros(lanes, dtype=rdt, device=dev)
    mp = torch.full((lanes,), float("inf"), dtype=rdt, device=dev)
    npc = torch.zeros(lanes, dtype=torch.int32, device=dev)
    ph = torch.ones(lanes, dtype=rdt, device=dev)
    child_rng = None
    for d in range(len(plan.levels) - 1, -1, -1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        rng = None if split is None else split.block(lv.n_nodes)
        blk = _block(plan, dp, d, rng)
        fr = _assemble(lv, dl, uniq_re, blk=blk)
        fi = _assemble(lv, dl, uniq_im, ghost=False, blk=blk) if cplx \
            else None
        if sch_re is not None:
            sch_re, sch_im = _regroup(split, child_rng, rng, (sch_re, sch_im))
            tr, ti = _embed_mat(dl, sch_re, sch_im)
            fr = fr + tr
            if cplx:
                fi = fi + ti
        e = lv.e
        Sr, Si = fr[:, :e, :e], (fi[:, :e, :e] if cplx else None)
        Br = fr[:, :e, e:].contiguous()
        Bi = fi[:, :e, e:].contiguous() if cplx else None
        Cr, Ci = fr[:, e:, :e], (fi[:, e:, :e] if cplx else None)
        Rr, Ri = fr[:, e:, e:], (fi[:, e:, e:] if cplx else None)
        SIr, SIi, ld_d, mp_d, np_d, ph_d = _inv_planes(Sr, Si, delta)
        ld_d, mp_d, np_d, ph_d = _combine(split, rng, ld_d, mp_d, np_d, ph_d)
        Lr, Li = _mm(Cr, Ci, SIr, SIi)
        Ur, Ui = _mm(Lr, Li, Br, Bi)
        sch_re = Rr - Ur
        sch_im = (Ri - Ui) if cplx else None
        store[d] = {"sir": SIr, "sii": SIi, "lr": Lr, "li": Li,
                    "br": Br, "bi": Bi}
        ranges[d] = child_rng = rng
        ld = ld + ld_d
        mp = torch.minimum(mp, mp_d)
        npc = npc + np_d
        if not cplx:
            ph = ph * ph_d
    fac = _stats_dict(batched, logdet=ld, phase=ph, min_pivot=mp,
                      n_perturbed=npc)
    fac["levels"] = store
    if split is not None:
        fac["ranges"] = ranges
    return fac


def _lane_data(name, data, split):
    """(complex?, real dtype, batched?, data as (lanes, nnz)) of a
    factorization's entry values (nnz,) or (B, nnz); a batch with a
    ``split`` raises."""
    cplx = data.is_complex()
    rdt = data.real.dtype if cplx else data.dtype
    if rdt != torch.float64:
        raise TypeError(f"{name} factorizes float64/complex128, got "
                        f"{data.dtype}")
    if data.dim() not in (1, 2):
        raise ValueError(f"{name}: entry values (nnz,) or (B, nnz) "
                         f"expected, got {tuple(data.shape)}")
    batched = data.dim() == 2
    if batched and split is not None:
        raise ValueError(f"{name}: a split factorization takes one matrix, "
                         f"got a batch {tuple(data.shape)}")
    return cplx, rdt, batched, data.reshape(-1, data.shape[-1])


def _stats_dict(batched, **stats):
    """The statistics (lanes,) of a factorization; an unbatched one's as
    0-dim tensors."""
    return {k: v if batched else v[0] for k, v in stats.items()}


def _lane_rhs(name, bvec, split, stored, n_nodes):
    """(batched?, bvec as (lanes, n)) of a solve's right-hand side (n,) or
    (B, n), checked against the factors: ``stored`` fronts of a depth (or
    class) of ``n_nodes`` nodes a matrix (unchecked for split factors,
    which hold a rank's block)."""
    if bvec.dim() not in (1, 2):
        raise ValueError(f"{name}: right-hand side (n,) or (B, n) expected, "
                         f"got {tuple(bvec.shape)}")
    batched = bvec.dim() == 2
    if batched and split is not None:
        raise ValueError(f"{name}: a split solve takes one right-hand side, "
                         f"got {tuple(bvec.shape)}")
    lanes = bvec.shape[0] if batched else 1
    if split is None and stored != lanes * n_nodes:
        raise ValueError(f"{name}: right-hand side {tuple(bvec.shape)} does "
                         f"not match factors of {stored // n_nodes} "
                         "matrices")
    return batched, bvec.reshape(-1, bvec.shape[-1])


def gridmf_flops(plan: GridMfPlan) -> int:
    """Real-plane factorization flop count from the static schedule
    (pivot-block inverse ~2e^3 + panel 2re^2 + Schur 2r^2e per front) —
    lets artifacts report achieved GFLOP/s against chip peak."""
    return int(sum(lv.n_nodes * (2 * lv.e ** 3 + 2 * lv.r * lv.e * lv.e
                                 + 2 * lv.r * lv.r * lv.e)
                   for lv in plan.levels))


def gridmf_store_gb(plan: GridMfPlan, bytes_per: int = 8) -> float:
    """Factor storage per value plane ({Sinv, Lhat, B} per level), in GiB
    at ``bytes_per`` bytes a value (8: float64)."""
    return bytes_per * sum(lv.n_nodes * (lv.e * lv.e + 2 * lv.r * lv.e)
                           for lv in plan.levels) / 2 ** 30


def _solve_ranges(n_nodes, fac, split):
    """The node range of each depth (or class) that a solve through
    ``split`` runs, checked against the factorization's."""
    ranges = fac.get("ranges")
    if split is None:
        if ranges is not None and any(
                r is not None and r != (0, n) for r, n in zip(ranges,
                                                              n_nodes)):
            raise ValueError("these factors are split over ranks: solve "
                             "them through the parallel package")
        return [None] * len(n_nodes)
    want = [split.block(n) for n in n_nodes]
    if ranges != want:
        raise ValueError(f"the factors' node ranges {ranges} are not this "
                         f"rank's {want}")
    return want


def _scatter_blocks(split, x_planes, pending):
    """Write the split depths' (or classes') solution blocks into x: one
    all-gather of every block this rank holds, then each depth's rows in
    rank order, written at its elim vars ``ev``."""
    if not pending:
        return
    flat = torch.cat([blk.reshape(-1) for _, planes in pending
                      for blk in planes if blk is not None])
    rows = split.gather(flat).view(split.world, -1)
    off = 0
    for ev, planes in pending:
        for x, blk in zip(x_planes, planes):
            if blk is None:
                continue
            k = blk.numel()
            x.index_put_((ev,), rows[:, off:off + k].reshape(-1))
            off += k


def gridmf_solve(plan: GridMfPlan, fac, bvec, split=None):
    """x = A^{-1} b through the stored fronts: up-sweep (forward
    elimination of the rhs) then down-sweep (back-substitution), batched
    matrix-vector products. ``bvec`` is a tensor on the factors' device;
    x is complex128 when the factors are complex, else float64.

    ``split`` solves factors made with the same ``split``: each split
    depth's sweeps run on this rank's node block, the keep right-hand
    sides are all-gathered where the children are split and the parent is
    not, and the split depths' solution blocks are all-gathered into x,
    which every rank returns whole.

    The factors of a batch take ``bvec`` (B, n), one lane each, and
    return x (B, n)."""
    levels = fac["levels"]
    return _sweeps(plan, fac, bvec, split, levels[-1]["sir"].device,
                   levels.__getitem__, levels.__getitem__)


def _sweeps(plan: GridMfPlan, fac, bvec, split, dev, up, down):
    """``gridmf_solve``'s sweeps on ``dev``; ``up(d)`` and ``down(d)`` give
    depth d's stored factors where the up-sweep (d from the leaves to the
    root) and the down-sweep (from the root) read them."""
    cplx = fac["levels"][-1]["sii"] is not None
    sir = fac["levels"][-1]["sir"]
    rdt = sir.dtype
    batched, bvec = _lane_rhs("GRIDMF", bvec, split, sir.shape[0],
                              plan.levels[-1].n_nodes)
    L = bvec.shape[0]
    dp = _device_plan(plan, dev)
    ranges = _solve_ranges([lv.n_nodes for lv in plan.levels], fac, split)
    n = plan.n
    b_re = bvec.real if bvec.is_complex() else bvec
    bp_re = torch.zeros((L, n + 1), dtype=rdt, device=dev)
    bp_re[:, :n] = b_re
    bp_im = None
    if cplx:
        bp_im = torch.zeros((L, n + 1), dtype=rdt, device=dev)
        if bvec.is_complex():
            bp_im[:, :n] = bvec.imag

    D = len(plan.levels) - 1
    fe_st = [None] * (D + 1)
    fk_re = fk_im = None
    child_rng = None
    for d in range(D, -1, -1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        st = up(d)
        e = lv.e
        rng = ranges[d]
        blk = _block(plan, dp, d, rng)
        nn, ev = (lv.n_nodes, dl["ev"]) if blk is None else (blk["n"],
                                                             blk["ev"])
        fr = torch.zeros((L * nn, lv.F), dtype=rdt, device=dev)
        fi = torch.zeros((L * nn, lv.F), dtype=rdt, device=dev) \
            if cplx else None
        if fk_re is not None:
            fk_re, fk_im = _regroup(split, child_rng, rng, (fk_re, fk_im))
            tr, ti = _embed_vec(dl, fk_re, fk_im)
            fr = fr + tr
            if cplx:
                fi = fi + ti
        fr[:, :e] += bp_re.index_select(1, ev).view(L * nn, e)
        if cplx:
            fi[:, :e] += bp_im.index_select(1, ev).view(L * nn, e)
        fer, fei = fr[:, :e], (fi[:, :e] if cplx else None)
        fe_st[d] = (fer, fei)
        # keep-rhs update: fk - Lhat @ fe
        ur, ui = _mm(st["lr"], st["li"], fer[:, :, None],
                     fei[:, :, None] if cplx else None)
        fk_re = fr[:, e:] - ur[:, :, 0]
        fk_im = (fi[:, e:] - ui[:, :, 0]) if cplx else None
        child_rng = rng

    # x gets one slot past n: ghost elim vars (index n) are written there
    # and dropped
    x_re = torch.zeros((L, n + 1), dtype=rdt, device=dev)
    x_im = torch.zeros((L, n + 1), dtype=rdt, device=dev) if cplx else None
    xf_re = xf_im = None
    parent_rng = None
    pending = []
    for d in range(0, D + 1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        st = down(d)
        rng = ranges[d]
        if d == 0:
            nn = lv.n_nodes if rng is None else rng[1] - rng[0]
            xk_re = torch.zeros((L * nn, lv.r), dtype=rdt, device=dev)
            xk_im = torch.zeros((L * nn, lv.r), dtype=rdt, device=dev) \
                if cplx else None
        else:
            if parent_rng is not None and rng is None:
                xf_re, xf_im = (None if v is None else split.gather(v)
                                for v in (xf_re, xf_im))
            xk_re, xk_im = _restrict_vec(lv, dl, xf_re, xf_im)
            if parent_rng is None and rng is not None:
                a, b = rng
                xk_re = xk_re[a:b]
                xk_im = xk_im[a:b] if cplx else None
        fer, fei = fe_st[d]
        br_, bi_ = _mm(st["br"], st["bi"], xk_re[:, :, None],
                       xk_im[:, :, None] if cplx else None)
        rr = fer - br_[:, :, 0]
        ri = (fei - bi_[:, :, 0]) if cplx else None
        xer, xei = _mm(st["sir"], st["sii"], rr[:, :, None],
                       ri[:, :, None] if cplx else None)
        xer = xer[:, :, 0]
        xei = xei[:, :, 0] if cplx else None
        if rng is None:
            x_re[:, dl["ev"]] = xer.reshape(L, -1)
            if cplx:
                x_im[:, dl["ev"]] = xei.reshape(L, -1)
        else:
            pending.append((dl["ev"], (xer, xei)))
        xf_re = torch.cat([xer, xk_re], dim=1)
        xf_im = torch.cat([xei, xk_im], dim=1) if cplx else None
        parent_rng = rng
    # a split solve has one lane
    _scatter_blocks(split, (x_re[0], x_im[0] if cplx else None), pending)
    x = torch.complex(x_re[:, :n], x_im[:, :n]) if cplx else x_re[:, :n]
    return x if batched else x[0]


# ---------------------------------------------------------------------------
# out of core: the factors in host memory
# ---------------------------------------------------------------------------


class HostLevels(list):
    """The per-depth factor stores of an out-of-core factorization, each
    {sir, lr, br} (``sii``, ``li``, ``bi`` None) a CPU tensor: pinned host
    memory when the factors were made on a CUDA device, ordinary tensors on
    the CPU. ``factor`` solves factors whose ``levels`` are HostLevels
    with ``gridmf_solve_ooc``."""

    @property
    def pinned_bytes(self) -> int:
        """Host bytes the stores hold registered with CUDA."""
        return sum(getattr(t, "_pinned", 0) for st in self
                   for t in st.values() if t is not None)


def _host_empty(shape, dtype, device):
    """An uninitialised CPU tensor for a store that ``device`` fills. For a
    CUDA device it is an anonymous private mapping of its own, its pages
    made by the kernel as it is mapped (``MAP_POPULATE``), then registered
    with CUDA whole (``cudaHostRegister``; ``t._pinned`` its bytes) and
    unregistered when the tensor goes: the store's own bytes are pinned,
    where torch's pinned allocator rounds each request up to a power of
    two. Registering pages that are not populated yet, whole or a chunk at
    a time, runs about half as fast (``ooc_variants.py``)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if device.type != "cuda" or not nbytes:
        return torch.empty(shape, dtype=dtype)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                    | mmap.MAP_POPULATE)
    t = torch.frombuffer(buf, dtype=dtype).view(shape)
    torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), nbytes, 0))
    t._pinned = nbytes
    weakref.finalize(t, _unpin, t.data_ptr(), buf).atexit = False
    return t


def _unpin(ptr, buf):
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


def _chunked(lv: _Level, itm: int) -> bool:
    """Whether a depth's fronts exceed GRIDMF_CHUNK_GB: it is then
    assembled and factorized a node chunk at a time."""
    return lv.n_nodes * lv.F * lv.F * itm > GRIDMF_CHUNK_GB * 2 ** 30


def _ooc_stores(plan: GridMfPlan, dtype, device):
    """The host stores of an out-of-core factorization, all made before
    its first depth: each depth's {sir, lr, br}, and two buffers that the
    chunked depths' Schur complements take in turn (a depth's, and its
    children's that it reads), each as large as the largest of them."""
    itm = torch.empty((), dtype=dtype).element_size()
    levels = HostLevels(
        {"sir": _host_empty((lv.n_nodes, lv.e, lv.e), dtype, device),
         "sii": None,
         "lr": _host_empty((lv.n_nodes, lv.r, lv.e), dtype, device),
         "li": None,
         "br": _host_empty((lv.n_nodes, lv.e, lv.r), dtype, device),
         "bi": None} for lv in plan.levels)
    most = max([lv.n_nodes * lv.r * lv.r for lv in plan.levels
                if _chunked(lv, itm)], default=0)
    return levels, [_host_empty((most,), dtype, device) for _ in range(2)]


class _Copies:
    """The host copies of an out-of-core factorization or solve on
    ``device``: device to host on one side stream, host to device on
    another, an event a copy, so that the compute stream overlaps them.
    Copies to the host in flight hold their device sources (``record_stream``
    on the copy's stream) up to ``inflight_bytes``, past which the host waits
    for the oldest. On the CPU the stores are the tensors themselves."""

    def __init__(self, device, inflight_bytes=0):
        self.device = device
        self.cuda = device.type == "cuda"
        self.limit = inflight_bytes
        self.pending = deque()          # (event, bytes) of copies to host
        self.inflight = 0
        if self.cuda:
            self.down = torch.cuda.Stream(device)
            self.up = torch.cuda.Stream(device)

    def to_host(self, host, lo, src):
        """Copy ``src`` (contiguous, on the device) into the elements of the
        store ``host`` from ``lo``."""
        n = src.numel()
        if not n:
            return
        dst = host.view(-1)[lo:lo + n]
        if not self.cuda:
            dst.copy_(src.reshape(-1))
            return
        self.down.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.down):
            dst.copy_(src.reshape(-1), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        src.record_stream(self.down)
        nbytes = n * src.element_size()
        self.pending.append((ev, nbytes))
        self.inflight += nbytes
        while self.inflight > self.limit and len(self.pending) > 1:
            ev, nbytes = self.pending.popleft()
            ev.synchronize()
            self.inflight -= nbytes

    def after_host_writes(self):
        """Copies to the device started from now on read what the copies to
        the host started so far wrote."""
        if self.cuda:
            self.up.wait_stream(self.down)

    def to_device(self, host, lo=0, hi=None, shape=None):
        """Start copying the elements [lo, hi) of the store ``host`` (all of
        it by default) to the device; ``ready`` gives the tensor, of
        ``shape`` (the store's by default)."""
        hi = host.numel() if hi is None else hi
        shape = host.shape if shape is None else shape
        src = host.view(-1)[lo:hi]
        if not self.cuda:
            return src.view(shape), None
        with torch.cuda.stream(self.up):
            out = torch.empty(hi - lo, dtype=host.dtype, device=self.device)
            out.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        return out.view(shape), ev

    def ready(self, copy):
        """The tensor of a ``to_device`` copy, once the current stream has
        waited for it."""
        t, ev = copy
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            t.record_stream(cur)
        return t

    def reads_done(self):
        """Wait for the copies to the device: what they read may go."""
        if self.cuda:
            self.up.synchronize()

    def finish(self):
        """Wait for every copy: the host stores are whole and no longer
        read."""
        self.reads_done()
        if self.cuda:
            self.down.synchronize()
        self.pending.clear()
        self.inflight = 0


def _factor_fronts(fr, e, delta):
    """``gridmf_factorize``'s steps on real fronts (n, F, F): the pivot
    blocks' inverse and each front's statistics (n,), the panels L = C
    S^-1, B, and the Schur complements R - L B."""
    SIr, ld, mp, npc, ph = _inv_block(fr[:, :e, :e], delta)
    SIr = SIr.contiguous()
    Br = fr[:, :e, e:].contiguous()
    Lr = fr[:, e:, :e] @ SIr
    return SIr, Lr, Br, fr[:, e:, e:] - Lr @ Br, (ld, mp, npc, ph)


def gridmf_factorize_ooc(plan: GridMfPlan, data):
    """Out-of-core factorization of one real matrix's entry values
    ``data`` (nnz,) on its device: each depth's factors {Sinv, Lhat, B} go
    to host memory as soon as they are made, so the device holds a depth's
    fronts and the Schur complements it passes up, never the whole store
    (the reference package's ``gridmf_factorize_ooc``, its role that of
    cuDSS's hybrid memory mode and MUMPS's out-of-core factors).

    A depth whose fronts take more than ``GRIDMF_CHUNK_GB`` is assembled
    and factorized a node chunk of at most that size at a time, its
    children's Schur complements shipped from host memory chunk by chunk
    (and this depth's sent there); a smaller one is assembled whole and
    factorized in even-aligned node chunks of about ``GRIDMF_STEP_GB`` of
    fronts, its Schur complements kept on the device. The extend-add is
    ``gridmf_factorize``'s gathers (the reference scatters here to save
    its device memory; the gathers give the in-core path's bits), each
    chunk runs the in-core path's operations on its nodes, and a depth's
    statistics are reduced over its fronts as there.

    On a CUDA device the stores are pinned host memory, all made before
    the first depth (``_ooc_stores``), filled on a side stream while the
    next chunk computes; on the CPU they are ordinary tensors. Returns
    ``gridmf_factorize``'s fac dict, its ``levels`` a ``HostLevels``.
    Complex values raise NotImplementedError, as in the reference
    package."""
    if data.is_complex():
        raise NotImplementedError(
            "out-of-core GRIDMF factorizes real matrices only, as the "
            "reference package does")
    _, rdt, batched, data = _lane_data("GRIDMF", data, None)
    if batched:
        raise ValueError("out-of-core GRIDMF factorizes one matrix, got a "
                         f"batch {tuple(data.shape)}")
    dev = data.device
    dp = _device_plan(plan, dev)
    uniq = _presum(plan, dp, data)
    delta = plan.pivot_epsilon * (1.0 + data.abs().amax(-1))
    io = _Copies(dev, 2 * GRIDMF_CHUNK_GB * 2 ** 30)
    store, sch_bufs = _ooc_stores(plan, rdt, dev)
    ld = torch.zeros(1, dtype=rdt, device=dev)
    mp = torch.full((1,), float("inf"), dtype=rdt, device=dev)
    npc = torch.zeros(1, dtype=torch.int32, device=dev)
    ph = torch.ones(1, dtype=rdt, device=dev)
    sch = None            # the children's Schur complements: device or host
    try:
        for d in range(len(plan.levels) - 1, -1, -1):
            sch, (ld_f, mp_f, np_f, ph_f) = _ooc_depth(
                plan, dp, d, uniq, delta, sch, store[d], sch_bufs[d % 2],
                io)
            # the depth's statistics over its fronts, as _inv_planes
            # reduces them
            ld = ld + ld_f.view(1, -1).sum(-1)
            mp = torch.minimum(mp, mp_f.view(1, -1).amin(-1))
            npc = npc + np_f.view(1, -1).sum(-1, dtype=torch.int32)
            ph = ph * ph_f.view(1, -1).prod(-1)
    finally:
        io.finish()       # no copy outlives the stores it reads or writes
    fac = _stats_dict(False, logdet=ld, phase=ph, min_pivot=mp,
                      n_perturbed=npc)
    fac["levels"] = store
    return fac


def _ooc_depth(plan: GridMfPlan, dp, d, uniq, delta, sch, st, sch_buf, io):
    """Depth ``d`` of ``gridmf_factorize_ooc``, from its children's Schur
    complements ``sch`` (on the device, or in a host buffer), into its host
    stores ``st``: returns its own Schur complements (in the host buffer
    ``sch_buf`` where the depth is chunked, else on the device) and its
    fronts' statistics (ld, mp, npc, ph), each (n_nodes,)."""
    lv, dl = plan.levels[d], dp["levels"][d]
    nn, F, e, r = lv.n_nodes, lv.F, lv.e, lv.r
    dev = uniq.device
    itm = uniq.element_size()
    io.after_host_writes()
    chunked = _chunked(lv, itm)
    if chunked:
        # node chunks of at most GRIDMF_CHUNK_GB of fronts, each assembled
        # on its own with its children's Schur rows [2a, 2b)
        c = min(max(1, int(GRIDMF_CHUNK_GB * 2 ** 30 // (F * F * itm))), nn)
        out = sch_buf[:nn * r * r].view(nn, r, r)
    else:
        fr = _assemble(lv, dl, uniq)
        if sch is not None:
            s = io.ready(io.to_device(sch)) if sch.device != dev else sch
            fr = fr + _embed_mat(dl, s, None)[0]
            del s
        # even-aligned chunks of about GRIDMF_STEP_GB of fronts
        nch = max(1, math.ceil(nn * F * F * itm / (GRIDMF_STEP_GB * 2 ** 30)))
        c = max(2, 2 * math.ceil(nn / (2 * nch)))
        out = []
    bounds = [(a, min(a + c, nn)) for a in range(0, nn, c)]

    def child(a, b):
        if not chunked or sch is None:
            return None, None
        if sch.device == dev:
            return sch[2 * a:2 * b], None
        q = sch[0].numel()
        return io.to_device(sch, 2 * a * q, 2 * b * q,
                            (2 * (b - a),) + tuple(sch.shape[1:]))

    stats = []
    nxt = child(*bounds[0])
    for i, (a, b) in enumerate(bounds):
        if chunked:
            sc = io.ready(nxt)
            if i + 1 < len(bounds):
                nxt = child(*bounds[i + 1])      # overlaps this chunk
            frc = _assemble(lv, dl, uniq, blk=_block(plan, dp, d, (a, b)))
            if sc is not None:
                frc = frc + _embed_mat(dl, sc, None)[0]
            del sc
        else:
            frc = fr[a:b]
        SIr, Lr, Br, sch_c, st_c = _factor_fronts(frc, e, delta)
        del frc
        stats.append(st_c)
        io.to_host(st["sir"], a * e * e, SIr)
        io.to_host(st["lr"], a * r * e, Lr)
        io.to_host(st["br"], a * e * r, Br)
        if chunked:
            io.to_host(out, a * r * r, sch_c)
        else:
            out.append(sch_c)
        del SIr, Lr, Br, sch_c
    io.reads_done()       # the children's buffer is read: it may be reused
    if not chunked:
        out = out[0] if len(out) == 1 else torch.cat(out)
    return out, [torch.cat(v) for v in zip(*stats)]


def gridmf_solve_ooc(plan: GridMfPlan, fac, bvec):
    """x = A^{-1} b for factors in host memory (``gridmf_factorize_ooc``'s,
    or the reference package's carried over by ``interop``): the up-sweep
    ships each depth's Lhat to ``bvec``'s device when it reaches it, the
    down-sweep each depth's Sinv and B, the next depth's copy running on a
    side stream while the current one computes, so the device holds about
    the largest level and the next. ``gridmf_solve``'s operations on one
    real right-hand side (n,) (the same bits)."""
    if bvec.dim() != 1 or bvec.is_complex():
        raise ValueError("out-of-core GRIDMF solves one real right-hand "
                         f"side (n,), got {tuple(bvec.shape)} {bvec.dtype}")
    levels = fac["levels"]
    io = _Copies(bvec.device)
    D = len(levels) - 1
    order = ([(d, ("lr",)) for d in range(D, -1, -1)]
             + [(d, ("sir", "br")) for d in range(D + 1)])
    ships = {}

    def ship(i):
        d, keys = order[i]
        ships[i] = {k: io.to_device(levels[d][k]) for k in keys}

    def get(i):
        if i + 1 < len(order):
            ship(i + 1)
        got = {k: io.ready(c) for k, c in ships.pop(i).items()}
        return {"sii": None, "li": None, "bi": None, **got}

    ship(0)
    try:
        x = _sweeps(plan, fac, bvec, None, bvec.device,
                    lambda d: get(D - d), lambda d: get(D + 1 + d))
    finally:
        io.finish()
    return x
