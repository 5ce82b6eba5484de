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

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from russell_tpu_torch.sparse.ordering import idx32 as _idx32, rank_passes
from russell_tpu_torch.sparse.splu import _inv_block

__all__ = ["GridMfPlan", "gridmf_analyze", "gridmf_factorize",
           "gridmf_solve", "gridmf_flops", "gridmf_store_gb"]


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
    diagonal has three entries: Jacobian, Laplacian centre, mass)."""
    out = torch.zeros(plan.n_uniq, dtype=data.dtype, device=data.device)
    for perm, seg in dp["presum"]:
        out.index_add_(0, seg, data.index_select(0, perm))
    return out


def _assemble(lv: _Level, dl, uniq, ghost=True):
    """The depth's fronts (n_nodes, F, F) from the pre-summed values; with
    ``ghost``, a unit diagonal in every ghost pivot slot (the REAL plane
    only, so each contributes exactly 0 to log|det|). Every position is
    written once: the ghost and entry positions are unique and apart."""
    F = lv.F
    flat = torch.zeros(lv.n_nodes * F * F, dtype=uniq.dtype,
                       device=uniq.device)
    if ghost and len(lv.ghost_diag):
        # a device scalar: a Python one is copied from the host
        flat[dl["gd"]] = flat.new_ones(())
    if lv.asm_len:
        flat.index_put_((dl["asm"],),
                        uniq[lv.asm_off:lv.asm_off + lv.asm_len])
    return flat.view(lv.n_nodes, F, F)


def _embed_mat(parent_dl, schur_re, schur_im):
    """Extend-add both children's Schur complements into zero-initialised
    parent fronts: T[n, a, b] = Sch[n, side, inv[a], inv[b]] as two gathers
    with constant index vectors per side (ghost overflow positions read a
    zero pad slot)."""
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
    K determinant is |det|^2 -> halve log|det|, phase unrecoverable."""
    if Si is None:
        Dinv, ld, mp, npc, ph = _inv_block(Sr, delta)
        return (Dinv.contiguous(), None, ld.sum(), mp.amin(),
                npc.sum(dtype=torch.int32), ph.prod())
    e = Sr.shape[-1]
    K = torch.cat([torch.cat([Sr, -Si], dim=-1),
                   torch.cat([Si, Sr], dim=-1)], dim=-2)
    Kinv, ld, mp, npc, _ = _inv_block(K, delta)
    return (Kinv[:, :e, :e].contiguous(), Kinv[:, e:, :e].contiguous(),
            0.5 * ld.sum(), mp.amin(), npc.sum(dtype=torch.int32),
            torch.ones((), dtype=Sr.dtype, device=Sr.device))


def gridmf_factorize(plan: GridMfPlan, data):
    """Batched multifrontal factorization of the entry values ``data`` (an
    f64 or complex128 tensor on the device to factorize on, in the plan's
    entry order). Returns a fac dict with per-depth ``levels[d]`` =
    {sir, sii, lr, li, br, bi} (planes; the imaginary ones None for a real
    matrix) plus logdet / phase / min_pivot / n_perturbed (0-dim tensors;
    phase is the determinant's sign for real matrices, 1 for complex)."""
    cplx = data.is_complex()
    rdt = data.real.dtype if cplx else data.dtype
    if rdt != torch.float64:
        raise TypeError(f"GRIDMF factorizes float64/complex128, got "
                        f"{data.dtype}")
    dev = data.device
    dp = _device_plan(plan, dev)
    if cplx:
        uniq_re = _presum(plan, dp, data.real)
        uniq_im = _presum(plan, dp, data.imag)
    else:
        uniq_re = _presum(plan, dp, data)
        uniq_im = None
    delta = plan.pivot_epsilon * (1.0 + data.abs().max())

    store = [None] * len(plan.levels)
    sch_re = sch_im = None
    ld = torch.zeros((), dtype=rdt, device=dev)
    mp = torch.full((), float("inf"), dtype=rdt, device=dev)
    npc = torch.zeros((), dtype=torch.int32, device=dev)
    ph = torch.ones((), dtype=rdt, device=dev)
    for d in range(len(plan.levels) - 1, -1, -1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        fr = _assemble(lv, dl, uniq_re)
        fi = _assemble(lv, dl, uniq_im, ghost=False) if cplx else None
        if sch_re is not None:
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
        Lr, Li = _mm(Cr, Ci, SIr, SIi)
        Ur, Ui = _mm(Lr, Li, Br, Bi)
        sch_re = Rr - Ur
        sch_im = (Ri - Ui) if cplx else None
        store[d] = {"sir": SIr, "sii": SIi, "lr": Lr, "li": Li,
                    "br": Br, "bi": Bi}
        ld = ld + ld_d
        mp = torch.minimum(mp, mp_d)
        npc = npc + np_d
        if not cplx:
            ph = ph * ph_d
    return {"levels": store, "logdet": ld, "phase": ph, "min_pivot": mp,
            "n_perturbed": npc}


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


def gridmf_solve(plan: GridMfPlan, fac, bvec):
    """x = A^{-1} b through the stored fronts: up-sweep (forward
    elimination of the rhs) then down-sweep (back-substitution), batched
    matrix-vector products. ``bvec`` is a tensor on the factors' device;
    x is complex128 when the factors are complex, else float64."""
    cplx = fac["levels"][-1]["sii"] is not None
    sir = fac["levels"][-1]["sir"]
    rdt, dev = sir.dtype, sir.device
    dp = _device_plan(plan, dev)
    n = plan.n
    b_re = bvec.real if bvec.is_complex() else bvec
    bp_re = torch.zeros(n + 1, dtype=rdt, device=dev)
    bp_re[:n] = b_re
    bp_im = None
    if cplx:
        bp_im = torch.zeros(n + 1, dtype=rdt, device=dev)
        if bvec.is_complex():
            bp_im[:n] = bvec.imag

    D = len(plan.levels) - 1
    fe_st = [None] * (D + 1)
    fk_re = fk_im = None
    for d in range(D, -1, -1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        st = fac["levels"][d]
        e = lv.e
        ev = dl["ev"]
        fr = torch.zeros((lv.n_nodes, lv.F), dtype=rdt, device=dev)
        fi = torch.zeros((lv.n_nodes, lv.F), dtype=rdt, device=dev) \
            if cplx else None
        if fk_re is not None:
            tr, ti = _embed_vec(dl, fk_re, fk_im)
            fr = fr + tr
            if cplx:
                fi = fi + ti
        fr[:, :e] += bp_re.index_select(0, ev).view(lv.n_nodes, e)
        if cplx:
            fi[:, :e] += bp_im.index_select(0, ev).view(lv.n_nodes, e)
        fer, fei = fr[:, :e], (fi[:, :e] if cplx else None)
        fe_st[d] = (fer, fei)
        # keep-rhs update: fk - Lhat @ fe
        ur, ui = _mm(st["lr"], st["li"], fer[:, :, None],
                     fei[:, :, None] if cplx else None)
        fk_re = fr[:, e:] - ur[:, :, 0]
        fk_im = (fi[:, e:] - ui[:, :, 0]) if cplx else None

    # x gets one slot past n: ghost elim vars (index n) are written there
    # and dropped
    x_re = torch.zeros(n + 1, dtype=rdt, device=dev)
    x_im = torch.zeros(n + 1, dtype=rdt, device=dev) if cplx else None
    xf_re = xf_im = None
    for d in range(0, D + 1):
        lv = plan.levels[d]
        dl = dp["levels"][d]
        st = fac["levels"][d]
        if d == 0:
            xk_re = torch.zeros((1, lv.r), dtype=rdt, device=dev)
            xk_im = torch.zeros((1, lv.r), dtype=rdt, device=dev) \
                if cplx else None
        else:
            xk_re, xk_im = _restrict_vec(lv, dl, xf_re, xf_im)
        fer, fei = fe_st[d]
        br_, bi_ = _mm(st["br"], st["bi"], xk_re[:, :, None],
                       xk_im[:, :, None] if cplx else None)
        rr = fer - br_[:, :, 0]
        ri = (fei - bi_[:, :, 0]) if cplx else None
        xer, xei = _mm(st["sir"], st["sii"], rr[:, :, None],
                       ri[:, :, None] if cplx else None)
        xer = xer[:, :, 0]
        xei = xei[:, :, 0] if cplx else None
        x_re.index_put_((dl["ev"],), xer.reshape(-1))
        if cplx:
            x_im.index_put_((dl["ev"],), xei.reshape(-1))
        xf_re = torch.cat([xer, xk_re], dim=1)
        xf_im = torch.cat([xei, xk_im], dim=1) if cplx else None
    if cplx:
        return torch.complex(x_re[:n], x_im[:n])
    return x_re[:n]
