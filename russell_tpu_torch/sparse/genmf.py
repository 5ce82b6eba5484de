"""General-matrix nested-dissection multifrontal solver (GENMF) in
PyTorch.

Counterpart of ``russell_tpu.sparse.genmf``: the solver the reference
package routes general sparse systems to (``factor.analyze`` with
``Genie.AUTO`` above ``dense_threshold`` when the RCM bandwidth exceeds
``max_block``): irregular circuit / FEM-class patterns with no grid. Where
GRIDMF exploits exact congruence of a regular grid's separators, GENMF
builds a nested-dissection tree on the general adjacency graph and
*manufactures* congruence by bucketing fronts into padded size classes:

- **symbolic (host, numpy)**: recursive vertex bisection (George–Liu:
  pseudo-peripheral BFS, median level-set separator, trimmed to vertices
  that face the far side). Each tree node eliminates its separator (or
  leaf remainder) and keeps the boundary ``N(subtree) \\ subtree``, which
  the parent's ``elim ∪ keep`` contains, so the child -> parent
  extend-add is a position map. Nodes are grouped into (depth, e_pad,
  r_pad) classes with geometric padding; padded pivot slots get a unit
  diagonal (log|det| 0), padded keep slots stay zero. Copied from the
  reference package, so both build equal plans (every array equal).
- **numeric (device)**: per class, deepest first: assemble the fronts
  (pre-summed entry values), extend-add the children's Schur complements
  (one gather per child-class link, added one duplicate parent slot a
  pass), invert the pivot block with ``gridmf._inv_planes`` ->
  ``splu._inv_block`` (the ``gj_inv`` CUDA kernel on the card), then the
  panel and Schur products as batched matmuls.
- **solve (device)**: an up-sweep of the right-hand side through the
  stored panels, then a down-sweep of back-substitution.

Complex systems run as real and imaginary planes with Karatsuba products,
the pivot block inverted through its real embedding, as in GRIDMF and the
reference package; log|det| is exact and the complex phase (1 in the
factorization) comes from ``factor.det_phase``. Every sum whose addends
meet at one address runs one duplicate rank a pass, so the card gives
the same bits on every run. Every index array the numeric phase reads is
uploaded once per (plan, device) (``_device_plan``).

Reference role: analyze/factorize/solve of MUMPS on general matrices
(interface_mumps.c JOB_ANALYZE/FACTORIZE/SOLVE); orderings analog:
enums.rs Ordering::Metis (nested dissection).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from russell_tpu_torch.sparse.gridmf import (_combine, _inv_planes,
                                             _lane_data, _lane_rhs, _mm,
                                             _node_block, _scatter_blocks,
                                             _solve_ranges, _stats_dict)
from russell_tpu_torch.sparse.ordering import idx32 as _idx32, rank_passes

__all__ = ["GenMfPlan", "genmf_analyze", "genmf_factorize", "genmf_solve"]


# ---------------------------------------------------------------------------
# host symbolic phase
# ---------------------------------------------------------------------------


def _adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetrized, dedup'd CSR adjacency of the pattern, no diagonal."""
    m = rows != cols
    r = np.concatenate([rows[m], cols[m]])
    c = np.concatenate([cols[m], rows[m]])
    key = np.unique(r * np.int64(n) + c)
    r = (key // n).astype(np.int64)
    c = (key % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return indptr, c


def _neighbors(indptr, adj, verts):
    """All neighbors of ``verts`` (with duplicates)."""
    starts = indptr[verts]
    counts = indptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.repeat(starts, counts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts))
    return adj[idx]


def _bfs_levels(indptr, adj, inset, start, level):
    """BFS level structure within ``inset`` from ``start``; fills
    ``level`` (callers pre-reset their region to -1). Returns
    (levels list of vertex arrays, last frontier's last vertex)."""
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    levels = [frontier]
    while True:
        nbr = _neighbors(indptr, adj, frontier)
        nbr = nbr[inset[nbr] & (level[nbr] < 0)]
        if len(nbr) == 0:
            break
        nbr = np.unique(nbr)
        level[nbr] = len(levels)
        levels.append(nbr)
        frontier = nbr
    return levels


@dataclass
class _Node:
    elim: np.ndarray      # eliminated vars (separator or leaf), sorted
    keep: np.ndarray      # boundary N(subtree)\subtree, sorted
    parent: int           # node index or -1
    depth: int


def _build_tree(n, indptr, adj, leaf_target) -> List[_Node]:
    """Nested-dissection tree by recursive level-set bisection."""
    nodes: List[_Node] = []
    level = np.full(n, -1, dtype=np.int64)
    inset = np.zeros(n, dtype=bool)
    all_verts = np.arange(n, dtype=np.int64)
    # task: (verts, keep, parent, depth)
    stack = [(all_verts, np.zeros(0, dtype=np.int64), -1, 0)]
    while stack:
        verts, keep, parent, depth = stack.pop()
        if len(verts) <= leaf_target:
            nodes.append(_Node(np.sort(verts), keep, parent, depth))
            continue
        inset[verts] = True
        level[verts] = -1
        # pseudo-peripheral start: min-degree seed, two BFS sweeps
        degs = indptr[verts + 1] - indptr[verts]
        start = verts[int(np.argmin(degs))]
        levels = _bfs_levels(indptr, adj, inset, start, level)
        if len(levels[-1]):
            level[verts] = -1
            levels = _bfs_levels(indptr, adj, inset, levels[-1][-1], level)
        nreach = sum(len(lv) for lv in levels)
        if nreach < len(verts):
            # disconnected: recurse per piece (no separator between them)
            inset[verts] = False
            reached = np.concatenate(levels)
            um = np.ones(n, dtype=bool)
            um[reached] = False
            unreached = verts[um[verts]]
            for piece in (reached, unreached):
                # pieces are unions of components of the induced
                # subgraph, so N(piece)\piece never touches verts: it is
                # a subset of keep(V)
                pk = np.setdiff1d(np.unique(_neighbors(indptr, adj, piece)),
                                  piece, assume_unique=False)
                stack.append((piece, np.sort(pk), parent, depth))
            continue
        if len(levels) < 3:
            # connected, diameter < 2: cannot bisect — emit as one node
            inset[verts] = False
            nodes.append(_Node(np.sort(verts), keep, parent, depth))
            continue
        # median level split
        sizes = np.array([len(lv) for lv in levels])
        cum = np.cumsum(sizes)
        half = int(np.searchsorted(cum, nreach // 2))
        half = min(max(half, 1), len(levels) - 2)
        sep0 = levels[half]
        # trim: separator members with no neighbor beyond the split line
        # belong to the near side (George–Liu minimal separator step)
        nbrs = _neighbors(indptr, adj, sep0)
        counts = indptr[sep0 + 1] - indptr[sep0]
        far = inset[nbrs] & (level[nbrs] > half)
        seg = np.repeat(np.arange(len(sep0)), counts)
        faces_far = np.bincount(seg[far], minlength=len(sep0)) > 0
        sep = sep0[faces_far]
        if len(sep) == 0:
            sep = sep0
            faces_far = np.ones(len(sep0), dtype=bool)
        a_side = np.concatenate(levels[:half] + [sep0[~faces_far]])
        b_side = np.concatenate(levels[half + 1:])
        inset[verts] = False
        me = len(nodes)
        nodes.append(_Node(np.sort(sep), keep, parent, depth))
        for side in (a_side, b_side):
            if len(side) == 0:
                continue
            sk = np.setdiff1d(np.unique(_neighbors(indptr, adj, side)),
                              side, assume_unique=False)
            stack.append((side, np.sort(sk), me, depth + 1))
    return nodes


_BUCKETS = np.array(
    [1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
     1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576, 32768],
    dtype=np.int64)


def _bucket(v: int) -> int:
    i = int(np.searchsorted(_BUCKETS, max(v, 1)))
    if i < len(_BUCKETS):
        return int(_BUCKETS[i])
    return int(-(-v // 1024) * 1024)


@dataclass
class _GLink:
    """Extend-add of one child class's Schur into one parent class."""

    src: int                   # child class index
    parent_slot: np.ndarray    # (m,) rows in the parent class batch
    child_slot: np.ndarray     # (m,) rows in the child class batch
    inv: np.ndarray            # (m, F_parent): child keep pos or r_src(=0)
    fwd: np.ndarray            # (m, r_src): parent front pos or F_parent(=0)


@dataclass
class _GClass:
    """One (depth, e_pad, r_pad) congruence class (host arrays)."""

    depth: int
    e: int
    r: int
    n_nodes: int
    elim_var: np.ndarray = None     # (n_nodes, e) global var or n (pad)
    pad_diag: np.ndarray = None     # flat idx into (n_nodes*F*F): +1.0
    asm_idx: np.ndarray = None
    asm_off: int = 0
    asm_len: int = 0
    links: List[_GLink] = field(default_factory=list)

    @property
    def F(self):
        return self.e + self.r


@dataclass
class GenMfPlan:
    """Symbolic output. ``classes`` is ordered deepest-first (the device
    elimination order); links always point from a later (deeper) class
    to an earlier one."""

    n: int
    classes: List[_GClass] = field(default_factory=list)
    entry_perm: np.ndarray = None
    entry_seg: np.ndarray = None
    n_uniq: int = 0
    pivot_epsilon: float = 1e-14
    flops: int = 0                   # factorization flop estimate
    store_f32_gb: float = 0.0        # per-plane factor storage

    def stats_dict(self):
        return {"n_classes": len(self.classes),
                "n_fronts": int(sum(c.n_nodes for c in self.classes)),
                "flops": int(self.flops),
                "store_f32_gb": round(self.store_f32_gb, 3)}


def genmf_analyze(n: int, rows, cols, leaf_target: int = 96,
                  pivot_epsilon: float = 1e-14) -> GenMfPlan:
    """Symbolic phase for a general pattern (no grid hint needed)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    indptr, adj = _adjacency(n, rows, cols)
    nodes = _build_tree(n, indptr, adj, leaf_target)

    # var -> (home node, elim position)
    home = np.full(n, -1, dtype=np.int64)
    epos = np.full(n, -1, dtype=np.int64)
    for t, nd in enumerate(nodes):
        home[nd.elim] = t
        epos[nd.elim] = np.arange(len(nd.elim))
    assert np.all(home >= 0), "every var must be eliminated exactly once"

    # classes
    cls_of: Dict[Tuple[int, int, int], int] = {}
    classes: List[_GClass] = []
    node_cls = np.zeros(len(nodes), dtype=np.int64)
    node_slot = np.zeros(len(nodes), dtype=np.int64)
    for t, nd in enumerate(nodes):
        key = (nd.depth, _bucket(len(nd.elim)), _bucket(len(nd.keep))
               if len(nd.keep) else 0)
        if key not in cls_of:
            cls_of[key] = len(classes)
            classes.append(_GClass(depth=key[0], e=key[1], r=key[2],
                                   n_nodes=0))
        ci = cls_of[key]
        node_cls[t] = ci
        node_slot[t] = classes[ci].n_nodes
        classes[ci].n_nodes += 1

    # order classes deepest-first; links then always point backwards
    order = sorted(range(len(classes)),
                   key=lambda i: (-classes[i].depth, i))
    rank = np.zeros(len(classes), dtype=np.int64)
    for newi, oldi in enumerate(order):
        rank[oldi] = newi
    classes = [classes[i] for i in order]
    node_cls = rank[node_cls]

    # per-class buffers
    for c in classes:
        c.elim_var = np.full((c.n_nodes, c.e), n, dtype=np.int64)
        c._pd = []
    for t, nd in enumerate(nodes):
        c = classes[node_cls[t]]
        sl = node_slot[t]
        e_real = len(nd.elim)
        c.elim_var[sl, :e_real] = nd.elim
        if e_real < c.e:
            F = c.F
            pd = (sl * F + np.arange(e_real, c.e)) * F \
                + np.arange(e_real, c.e)
            c._pd.append(pd)
    for c in classes:
        c.pad_diag = (np.concatenate(c._pd).astype(np.int64)
                      if c._pd else np.zeros(0, dtype=np.int64))
        del c._pd

    # entry assembly: home node of an entry is the DEEPER endpoint's node
    depth_of = np.array([nd.depth for nd in nodes], dtype=np.int64)
    di = depth_of[home[rows]]
    dj = depth_of[home[cols]]
    hn = np.where(di >= dj, home[rows], home[cols])
    # keep slots start at the CLASS-PADDED e, not the node's real e
    epad_of = np.array([classes[node_cls[t]].e for t in range(len(nodes))],
                       dtype=np.int64)
    keep_off = np.zeros(len(nodes) + 1, dtype=np.int64)
    keep_off[1:] = np.cumsum([len(nd.keep) for nd in nodes])
    keep_cat = (np.concatenate([nd.keep for nd in nodes])
                if keep_off[-1] else np.zeros(0, dtype=np.int64))

    def pos_in(vals, hn):
        """Front position of each var within its (padded) home front;
        vectorized per-segment binary search over concatenated keeps."""
        pos = np.empty(len(vals), dtype=np.int64)
        is_elim = home[vals] == hn
        pos[is_elim] = epos[vals[is_elim]]
        rest = np.nonzero(~is_elim)[0]
        if len(rest):
            h = hn[rest]
            v = vals[rest]
            lo = keep_off[h]
            hi = keep_off[h + 1]
            l, r = lo.copy(), hi.copy()
            while np.any(l < r):
                mid = (l + r) // 2
                go_r = keep_cat[np.minimum(mid, len(keep_cat) - 1)] < v
                l = np.where((l < r) & go_r, mid + 1, l)
                r = np.where((l < r) & ~go_r, mid, r)
            found = (l < hi) & (keep_cat[np.minimum(
                l, max(len(keep_cat) - 1, 0))] == v)
            assert np.all(found), "entry endpoint outside home front"
            pos[rest] = epad_of[h] + (l - lo)
        return pos

    pi = pos_in(rows, hn)
    pj = pos_in(cols, hn)

    # global flat key: (class rank, slot, pi, pj)
    Fs = np.array([c.F for c in classes], dtype=np.int64)
    cls_e = node_cls[hn]
    F_e = Fs[cls_e]
    flat = (node_slot[hn] * F_e + pi) * F_e + pj
    stride = int(flat.max()) + 2 if len(flat) else 2
    key = cls_e * stride + flat
    order_e = np.argsort(key, kind="stable")
    uk, seg = np.unique(key[order_e], return_inverse=True)
    ud = uk // stride
    uflat = uk % stride
    for ci, c in enumerate(classes):
        sel = ud == ci
        c.asm_idx = uflat[sel].astype(np.int64)
        c.asm_off = int(np.searchsorted(ud, ci, side="left"))
        c.asm_len = int(sel.sum())

    # child -> parent links grouped by (parent class, child class)
    groups: Dict[Tuple[int, int], list] = {}
    for t, nd in enumerate(nodes):
        if nd.parent < 0 or len(nd.keep) == 0:
            continue
        p = nd.parent
        pc, cc = int(node_cls[p]), int(node_cls[t])
        groups.setdefault((pc, cc), []).append((p, t))
    for (pc, cc), pairs in groups.items():
        P, C = classes[pc], classes[cc]
        m = len(pairs)
        inv = np.full((m, P.F), C.r, dtype=np.int64)
        fwd = np.full((m, C.r), P.F, dtype=np.int64)
        pslot = np.empty(m, dtype=np.int64)
        cslot = np.empty(m, dtype=np.int64)
        for i, (p, t) in enumerate(pairs):
            pn, cn = nodes[p], nodes[t]
            pslot[i] = node_slot[p]
            cslot[i] = node_slot[t]
            # map child keep vars into the parent's (elim ++ keep) front
            kv = cn.keep
            in_elim = home[kv] == p
            ppos = np.empty(len(kv), dtype=np.int64)
            ppos[in_elim] = epos[kv[in_elim]]
            if np.any(~in_elim):
                j = np.searchsorted(pn.keep, kv[~in_elim])
                assert np.all((j < len(pn.keep))
                              & (pn.keep[np.minimum(j, len(pn.keep) - 1)]
                                 == kv[~in_elim])), \
                    "child keep var outside parent front"
                ppos[~in_elim] = P.e + j  # keep slots start at padded e
            inv[i, ppos] = np.arange(len(kv))
            fwd[i, :len(kv)] = ppos
        P.links.append(_GLink(src=cc, parent_slot=pslot, child_slot=cslot,
                              inv=inv, fwd=fwd))

    flops = 0
    store = 0
    for c in classes:
        e, r, m = c.e, c.r, c.n_nodes
        flops += m * (2 * e ** 3 + 2 * r * e * e + 2 * r * e * r)
        store += m * (e * e + 2 * r * e)
    plan = GenMfPlan(n=n, classes=classes,
                     entry_perm=order_e.astype(np.int64),
                     entry_seg=seg.astype(np.int64), n_uniq=len(uk),
                     pivot_epsilon=pivot_epsilon, flops=int(flops),
                     store_f32_gb=store * 4 / 2 ** 30)
    return plan


# ---------------------------------------------------------------------------
# index arrays on the device
# ---------------------------------------------------------------------------


def _device_plan(plan: GenMfPlan, device):
    """Every index array of the numeric phase on ``device`` (int32 where it
    fits), uploaded once per (plan, device) and kept on the plan:
    ``presum``, the passes of ``_presum``; per class ``pd`` / ``asm`` (the
    ghost-diagonal and assembly positions in the class's flat fronts),
    ``ev`` (elim vars, pads -> n) and per link ``cs`` / ``inv`` (the child
    slots and, per parent front position, the child keep position or the
    zero pad slot r), ``fwd`` (per child keep position, the parent front
    position or the zero pad slot F), ``ps`` (the parent slots) and
    ``passes`` (link rows and their parent slots, one duplicate rank a
    pass: two children of one parent in one class add in link order);
    ``free`` lists the classes whose Schur complements no later class
    reads."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    dp = cache.get(key)
    if dp is not None:
        return dp

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(_idx32(a)),
                               device=device)

    last_use = {}
    classes = []
    for ci, c in enumerate(plan.classes):
        links = []
        for link in c.links:
            last_use[link.src] = ci
            links.append({
                "cs": t(link.child_slot), "ps": t(link.parent_slot),
                "inv": t(link.inv), "fwd": t(link.fwd),
                "passes": [(t(ids), t(link.parent_slot[ids]))
                           for ids in rank_passes(link.parent_slot)]})
        classes.append({"pd": t(c.pad_diag), "asm": t(c.asm_idx),
                        "ev": t(c.elim_var.reshape(-1)), "links": links})
    for ci in range(len(plan.classes)):
        classes[ci]["free"] = [src for src, last in last_use.items()
                               if last == ci]
    # the pre-sum's passes: pass k takes the k-th entry of every unique
    # position that has more than k (entries are sorted by position)
    seg = plan.entry_seg
    presum = [(t(plan.entry_perm[ids]), t(seg[ids]))
              for ids in rank_passes(seg)]
    dp = cache[key] = {"presum": presum, "classes": classes}
    return dp


# ---------------------------------------------------------------------------
# device numeric phase
# ---------------------------------------------------------------------------


def _presum(plan: GenMfPlan, dp, data):
    """Duplicate entries collapse onto their unique front positions,
    summed in entry order, one duplicate rank a pass: (lanes, nnz) to
    (lanes, n_uniq)."""
    out = torch.zeros((data.shape[0], plan.n_uniq), dtype=data.dtype,
                      device=data.device)
    for perm, seg in dp["presum"]:
        out.index_add_(1, seg, data.index_select(1, perm))
    return out


def _block(plan: GenMfPlan, dp, ci, rng):
    """Class ``ci``'s node block [a, b) = ``rng`` (``gridmf._node_block``)
    with its links cut to the rows whose parent slot lies in the block,
    rebased to it, in link order (so each parent adds its children as the
    whole class does); None for no range or the whole class."""
    c = plan.classes[ci]
    dc = dp["classes"][ci]
    cache = dc.setdefault("blocks", {})
    fresh = rng is not None and rng not in cache
    blk = _node_block(cache, c.n_nodes, c.F, c.pad_diag, c.asm_idx,
                      c.asm_off, dc["ev"], rng)
    if blk is None or not fresh:
        return blk
    a, b = rng
    dev = dc["ev"].device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(_idx32(x)), device=dev)

    links = []
    for link in c.links:
        ids = np.flatnonzero((link.parent_slot >= a)
                             & (link.parent_slot < b))
        ps = link.parent_slot[ids] - a
        links.append({"cs": t(link.child_slot[ids]), "ps": t(ps),
                      "inv": t(link.inv[ids]),
                      "passes": [(t(k), t(ps[k])) for k in rank_passes(ps)]})
    blk["links"] = links
    return blk


def _assemble(c: _GClass, dc, uniq, ghost=True, blk=None):
    """The class's fronts (lanes * n_nodes, F, F), lane-major, from the
    pre-summed values (lanes, n_uniq); with ``ghost``, a unit diagonal in
    every padded pivot slot (the REAL plane only). The ghost and entry
    positions are unique and apart. With ``blk`` (``_block``) only that
    block of nodes."""
    F = c.F
    lanes = uniq.shape[0]
    n_nodes = c.n_nodes if blk is None else blk["n"]
    pd = dc["pd"] if blk is None else blk["gd"]
    flat = torch.zeros((lanes, n_nodes * F * F), dtype=uniq.dtype,
                       device=uniq.device)
    if ghost and pd.numel():
        flat[:, pd] = flat.new_ones(())
    if blk is None:
        if c.asm_len:
            flat[:, dc["asm"]] = uniq[:, c.asm_off:c.asm_off + c.asm_len]
    elif blk["asm"].numel():
        flat[:, blk["asm"]] = uniq.index_select(1, blk["src"])
    return flat.view(lanes * n_nodes, F, F)


def _gather_schur(dl, S, lanes):
    """(lanes, m, F_p, F_p) block of one child class's Schur complements
    (lanes * n_child, r, r): T[l, i, a, b] = S[l, cs[i], inv[i, a],
    inv[i, b]] (pad -> zero slot)."""
    Spad = tnf.pad(S.unflatten(0, (lanes, -1)), (0, 1, 0, 1))
    inv = dl["inv"]
    return Spad[:, dl["cs"][:, None, None], inv[:, :, None],
                inv[:, None, :]]


def _gather_vec(dl, v, lanes):
    return tnf.pad(v.unflatten(0, (lanes, -1)), (0, 1))[
        :, dl["cs"][:, None], dl["inv"]]


def _add_rows(front, dl, vals):
    """front[l, ps[i]] += vals[l, i] for the lanes l of ``vals`` (lanes,
    m, ...) and the lane-major ``front`` (lanes * n_nodes, ...), in link
    order where two rows share a parent slot (one duplicate rank a
    pass)."""
    front = front.unflatten(0, (vals.shape[0], -1))
    passes = dl["passes"]
    if len(passes) == 1:
        front.index_add_(1, dl["ps"], vals)
        return
    for ids, ps in passes:
        front.index_add_(1, ps, vals.index_select(1, ids))


def genmf_factorize(plan: GenMfPlan, data, split=None):
    """Batched multifrontal factorization over the size classes of the
    entry values ``data`` (an f64 or complex128 tensor on the device to
    factorize on, in the plan's entry order; f32 or complex64 for
    mixed-precision factors). Returns a fac dict with
    per-class ``classes[ci]`` = {sir, sii, lr, li, br, bi} (planes; the
    imaginary ones None for a real matrix, lr/li/br/bi None for a class
    with no keep) plus logdet / phase / min_pivot / n_perturbed (0-dim
    tensors; phase is the determinant's sign for real matrices, 1 for
    complex).

    ``split`` (``parallel.mesh.MeshAxis``) spreads the classes over ranks:
    a class whose node count it divides (``split.block``) assembles,
    extend-adds, inverts and updates only this rank's node block, and its
    Schur complements are all-gathered at once, since a parent's
    ``_gather_schur`` may read any child; the other classes run on every
    rank. A split class's statistics are summed over the ranks in rank
    order (``split.combine``). The fac then holds each class's block and,
    in ``ranges``, each class's node range (None: every node).

    ``data`` (B, nnz) factorizes B matrices at once, each class's fronts
    (B * n_nodes, ...) lane-major (``gridmf.gridmf_factorize``); a batch
    takes no ``split``."""
    cplx, rdt, batched, data = _lane_data("GENMF", data, split)
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

    store = [None] * len(plan.classes)
    ranges = [None] * len(plan.classes)
    schur_re: Dict[int, torch.Tensor] = {}
    schur_im: Dict[int, torch.Tensor] = {}
    ld = torch.zeros(lanes, dtype=rdt, device=dev)
    mp = torch.full((lanes,), float("inf"), dtype=rdt, device=dev)
    npc = torch.zeros(lanes, dtype=torch.int32, device=dev)
    ph = torch.ones(lanes, dtype=rdt, device=dev)
    for ci, c in enumerate(plan.classes):
        dc = dp["classes"][ci]
        rng = None if split is None else split.block(c.n_nodes)
        blk = _block(plan, dp, ci, rng)
        links = dc["links"] if blk is None else blk["links"]
        fr = _assemble(c, dc, uniq_re, blk=blk)
        fi = _assemble(c, dc, uniq_im, ghost=False, blk=blk) if cplx \
            else None
        for link, dl in zip(c.links, links):
            if not dl["passes"]:
                continue        # no parent of this block in the link
            _add_rows(fr, dl, _gather_schur(dl, schur_re[link.src], lanes))
            if cplx:
                _add_rows(fi, dl, _gather_schur(dl, schur_im[link.src],
                                                lanes))
        for src in dc["free"]:
            schur_re.pop(src)
            schur_im.pop(src, None)
        e = c.e
        Sr, Si = fr[:, :e, :e], (fi[:, :e, :e] if cplx else None)
        SIr, SIi, ld_d, mp_d, np_d, ph_d = _inv_planes(Sr, Si, delta)
        ld_d, mp_d, np_d, ph_d = _combine(split, rng, ld_d, mp_d, np_d, ph_d)
        Lr = Li = Br = Bi = None
        if c.r:
            Br = fr[:, :e, e:].contiguous()
            Bi = fi[:, :e, e:].contiguous() if cplx else None
            Cr, Ci = fr[:, e:, :e], (fi[:, e:, :e] if cplx else None)
            Lr, Li = _mm(Cr, Ci, SIr, SIi)
            Ur, Ui = _mm(Lr, Li, Br, Bi)
            schur_re[ci] = _whole(split, rng, fr[:, e:, e:] - Ur)
            if cplx:
                schur_im[ci] = _whole(split, rng, fi[:, e:, e:] - Ui)
        store[ci] = {"sir": SIr, "sii": SIi, "lr": Lr, "li": Li,
                     "br": Br, "bi": Bi}
        ranges[ci] = rng
        ld = ld + ld_d
        mp = torch.minimum(mp, mp_d)
        npc = npc + np_d
        if not cplx:
            ph = ph * ph_d
    fac = _stats_dict(batched, logdet=ld, phase=ph, min_pivot=mp,
                      n_perturbed=npc)
    fac["classes"] = store
    if split is not None:
        fac["ranges"] = ranges
    return fac


def _whole(split, rng, rows):
    """A split class's per-node rows over every node (all-gathered); a
    replicated class's as they are."""
    return rows if rng is None else split.gather(rows)


def genmf_solve(plan: GenMfPlan, fac, bvec, split=None):
    """x = A^{-1} b: up-sweep (rhs elimination, deepest classes first) then
    down-sweep (back-substitution), batched matrix-vector products.
    ``bvec`` is a tensor on the factors' device; x is complex when the
    factors are complex, else real, at the factors' precision.

    ``split`` solves factors made with the same ``split``: a split class's
    sweeps run on this rank's node block, and its keep right-hand sides
    (up) and front solutions (down) are all-gathered before another class
    reads them; every rank returns x whole. The factors of a batch take
    ``bvec`` (B, n) and return x (B, n)."""
    first = fac["classes"][0]
    cplx = first["sii"] is not None
    rdt, dev = first["sir"].dtype, first["sir"].device
    last = fac["classes"][-1]["sir"]
    batched, bvec = _lane_rhs("GENMF", bvec, split, last.shape[0],
                              plan.classes[-1].n_nodes)
    L = bvec.shape[0]
    dp = _device_plan(plan, dev)
    ranges = _solve_ranges([c.n_nodes for c in plan.classes], fac, split)
    n = plan.n
    bp_re = torch.zeros((L, n + 1), dtype=rdt, device=dev)
    bp_re[:, :n] = bvec.real if bvec.is_complex() else bvec
    bp_im = None
    if cplx:
        bp_im = torch.zeros((L, n + 1), dtype=rdt, device=dev)
        if bvec.is_complex():
            bp_im[:, :n] = bvec.imag

    fe_st = [None] * len(plan.classes)
    fk_re: Dict[int, torch.Tensor] = {}
    fk_im: Dict[int, torch.Tensor] = {}
    for ci, c in enumerate(plan.classes):
        dc = dp["classes"][ci]
        st = fac["classes"][ci]
        e = c.e
        rng = ranges[ci]
        blk = _block(plan, dp, ci, rng)
        nn, ev, links = ((c.n_nodes, dc["ev"], dc["links"]) if blk is None
                         else (blk["n"], blk["ev"], blk["links"]))
        fr = torch.zeros((L * nn, c.F), dtype=rdt, device=dev)
        fi = torch.zeros((L * nn, c.F), dtype=rdt, device=dev) \
            if cplx else None
        for link, dl in zip(c.links, links):
            if not dl["passes"]:
                continue
            _add_rows(fr, dl, _gather_vec(dl, fk_re[link.src], L))
            if cplx:
                _add_rows(fi, dl, _gather_vec(dl, fk_im[link.src], L))
        for src in dc["free"]:
            fk_re.pop(src)
            fk_im.pop(src, None)
        fr[:, :e] += bp_re.index_select(1, ev).view(L * nn, e)
        if cplx:
            fi[:, :e] += bp_im.index_select(1, ev).view(L * nn, e)
        fer, fei = fr[:, :e], (fi[:, :e] if cplx else None)
        fe_st[ci] = (fer, fei)
        if c.r:
            ur, ui = _mm(st["lr"], st["li"], fer[:, :, None],
                         fei[:, :, None] if cplx else None)
            fk_re[ci] = _whole(split, rng, fr[:, e:] - ur[:, :, 0])
            if cplx:
                fk_im[ci] = _whole(split, rng, fi[:, e:] - ui[:, :, 0])

    # x gets one slot past n: padded elim vars (index n) are written there
    # and dropped
    x_re = torch.zeros((L, n + 1), dtype=rdt, device=dev)
    x_im = torch.zeros((L, n + 1), dtype=rdt, device=dev) if cplx else None
    xk_re: Dict[int, torch.Tensor] = {}
    xk_im: Dict[int, torch.Tensor] = {}
    pending = []
    for ci in range(len(plan.classes) - 1, -1, -1):
        c = plan.classes[ci]
        dc = dp["classes"][ci]
        st = fac["classes"][ci]
        rng = ranges[ci]
        xkr = xk_re.pop(ci, None)
        if xkr is None:
            xkr = torch.zeros((L * c.n_nodes, c.r), dtype=rdt, device=dev)
            xki = torch.zeros((L * c.n_nodes, c.r), dtype=rdt,
                              device=dev) if cplx else None
        else:
            xki = xk_im.pop(ci) if cplx else None
        fer, fei = fe_st[ci]
        fe_st[ci] = None
        if c.r:
            cut = (slice(None) if rng is None or rng == (0, c.n_nodes)
                   else slice(*rng))
            br_, bi_ = _mm(st["br"], st["bi"], xkr[cut, :, None],
                           xki[cut, :, None] if cplx else None)
            rr = fer - br_[:, :, 0]
            ri = (fei - bi_[:, :, 0]) if cplx else None
        else:
            rr, ri = fer, fei
        xer, xei = _mm(st["sir"], st["sii"], rr[:, :, None],
                       ri[:, :, None] if cplx else None)
        xer = xer[:, :, 0]
        xei = xei[:, :, 0] if cplx else None
        if rng is not None and c.links:
            # the children of any node may read it: every node's solution
            xer = split.gather(xer)
            xei = split.gather(xei) if cplx else None
        if rng is None or c.links:
            x_re[:, dc["ev"]] = xer.reshape(L, -1)
            if cplx:
                x_im[:, dc["ev"]] = xei.reshape(L, -1)
        else:
            pending.append((dc["ev"], (xer, xei)))
        # distribute this class's front solution to its children's keeps
        if c.links:
            xf_re = tnf.pad(torch.cat([xer, xkr], dim=1), (0, 1))
            xf_im = (tnf.pad(torch.cat([xei, xki], dim=1), (0, 1))
                     if cplx else None)
            for link, dl in zip(c.links, dc["links"]):
                src = plan.classes[link.src]
                rows = dl["ps"][:, None]
                for xf, xk in ((xf_re, xk_re), (xf_im, xk_im)):
                    if xf is None:
                        continue
                    tgt = xk.get(link.src)
                    if tgt is None:
                        tgt = xk[link.src] = torch.zeros(
                            (L * src.n_nodes, src.r), dtype=rdt, device=dev)
                    # every child has one parent: the slots are unique
                    tgt.unflatten(0, (L, -1))[:, dl["cs"]] = xf.unflatten(
                        0, (L, -1))[:, rows, dl["fwd"]]
    # a split solve has one lane
    _scatter_blocks(split, (x_re[0], x_im[0] if cplx else None), pending)
    x = torch.complex(x_re[:, :n], x_im[:, :n]) if cplx else x_re[:, :n]
    return x if batched else x[0]
