"""Host-side orderings for the native factorizations.

The reference delegates ordering to its backends (AMD/COLAMD/METIS etc.,
russell_sparse/src/enums.rs:71-158). The *symbolic* phase runs on the host
(it is pointer-chasing, not FLOPs) and produces a static permutation that
shapes the numeric factorization:

- ND (nested dissection) gives SPLU a low-depth elimination tree
- MINDEG (approximate minimum degree flavor) minimizes fill for Genie.SPLU

RCM and the bandwidth helper of the reference module feed Genie.BANDED
and come with it (ROADMAP.md).

Pure NumPy, copied from ``russell_tpu.sparse.ordering`` so that both
packages build identical plans; the C++ engine in ``russell_tpu_torch.native``
(the same ``symbolic.cpp``) replaces these transparently (same outputs).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mindeg_ordering", "nd_ordering", "symmetrize_pattern", "idx32"]


def symmetrize_pattern(n, rows, cols):
    """Return adjacency (indptr, indices) of the symmetrized pattern A+A^T
    without the diagonal."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    off = rows != cols
    r = np.concatenate([rows[off], cols[off]])
    c = np.concatenate([cols[off], rows[off]])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    if len(r):
        keep = np.ones(len(r), dtype=bool)
        keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        r, c = r[keep], c[keep]
    counts = np.bincount(r, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, c


def nd_ordering(n, rows, cols, leaf: int = 64,
                with_regions: bool = False):
    """Nested dissection: recursive BFS-level bisection with the boundary
    level as separator. Eliminating leaves first and separators last gives
    a LOW-DEPTH elimination tree with WIDE independent level sets — the
    property the level-batched SPLU numeric phase (splu.py) exploits for
    batched parallelism (the role METIS plays for MUMPS, enums.rs:71-158).

    Returns ``order`` with order[k] = old index eliminated at position k.
    """
    from russell_tpu_torch import native
    nat = native.nd_order(n, rows, cols, leaf, with_regions=with_regions)
    if nat is not None:
        return nat
    indptr, adj = symmetrize_pattern(n, rows, cols)
    regions = []
    order_out = np.empty(n, dtype=np.int64)
    pos = 0
    # explicit stack of (verts, phase); separators are emitted after both
    # halves via a post-order marker
    stack = [("sep", None), ("split", np.arange(n, dtype=np.int64))]
    pending_seps = [np.zeros(0, dtype=np.int64)]

    def bfs_levels(verts):
        """BFS level of every vertex of the subgraph induced by verts."""
        vset = np.zeros(n, dtype=bool)
        vset[verts] = True
        lev = np.full(n, -1, dtype=np.int64)
        # pseudo-peripheral start: two BFS sweeps from a low-degree vertex
        deg = indptr[verts + 1] - indptr[verts]
        start = verts[np.argmin(deg)]
        for _sweep in range(2):
            lev[verts] = -1
            lev[start] = 0
            frontier = np.array([start], dtype=np.int64)
            last = start
            while len(frontier):
                nxt = []
                for u in frontier:
                    nbrs = adj[indptr[u]:indptr[u + 1]]
                    nbrs = nbrs[vset[nbrs] & (lev[nbrs] < 0)]
                    lev[nbrs] = lev[u] + 1
                    nxt.append(nbrs)
                frontier = (np.concatenate(nxt) if nxt
                            else np.zeros(0, dtype=np.int64))
                if len(frontier):
                    last = frontier[-1]
            start = last
        return lev

    while stack:
        kind, verts = stack.pop()
        if kind == "sep":
            sep = pending_seps.pop()
            order_out[pos:pos + len(sep)] = sep
            pos += len(sep)
            if len(sep):
                regions.append(len(sep))
            continue
        if len(verts) <= leaf:
            order_out[pos:pos + len(verts)] = verts
            pos += len(verts)
            if len(verts):
                regions.append(len(verts))
            continue
        lev = bfs_levels(verts)
        vl = lev[verts]
        unreached = verts[vl < 0]       # other components -> side B
        reached = verts[vl >= 0]
        rl = lev[reached]
        maxlev = int(rl.max()) if len(rl) else 0
        if maxlev < 2:
            if len(unreached):
                # disconnected region: recurse per component, no separator
                stack.append(("split", unreached))
                stack.append(("split", reached))
                continue
            # connected, diameter < 2: emit as a leaf
            order_out[pos:pos + len(verts)] = verts
            pos += len(verts)
            if len(verts):
                regions.append(len(verts))
            continue
        # split level: median vertex position
        counts = np.bincount(rl, minlength=maxlev + 1)
        half = np.searchsorted(np.cumsum(counts), len(reached) // 2)
        half = min(max(int(half), 1), maxlev - 1)
        A = reached[rl < half]
        S = reached[rl == half]
        B = np.concatenate([reached[rl > half], unreached])
        pending_seps.append(S)
        stack.append(("sep", None))
        if len(B):
            stack.append(("split", B))
        if len(A):
            stack.append(("split", A))
    assert pos == n
    if with_regions:
        return order_out, np.asarray(regions, dtype=np.int64)
    return order_out


def mindeg_ordering(n, rows, cols) -> np.ndarray:
    """Greedy minimum-degree ordering on the symmetrized quotient graph.

    A compact minimum-degree variant (no supervariables): good enough to cut
    fill substantially versus natural order; a full AMD can replace it later
    behind the same interface. Uses the native C++ engine when available.
    """
    from russell_tpu_torch import native
    nat = native.mindeg_order(n, rows, cols)
    if nat is not None:
        return nat
    indptr, adj = symmetrize_pattern(n, rows, cols)
    neighbors = [set(adj[indptr[i]:indptr[i + 1]].tolist()) for i in range(n)]
    eliminated = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)
    import heapq

    heap = [(len(neighbors[i]), i) for i in range(n)]
    heapq.heapify(heap)
    for k in range(n):
        while True:
            d, v = heapq.heappop(heap)
            if not eliminated[v] and d == len(neighbors[v]):
                break
        perm[k] = v
        eliminated[v] = True
        nbrs = [u for u in neighbors[v] if not eliminated[u]]
        # form the clique among v's neighbors (symbolic elimination)
        for u in nbrs:
            s = neighbors[u]
            s.discard(v)
            for w in nbrs:
                if w != u:
                    s.add(w)
            heapq.heappush(heap, (len(s), u))
        neighbors[v] = set()
    return perm


def idx32(a):
    """An index array as int32 when every index fits (the device index
    arrays of GRIDMF: half the bytes of int64); otherwise unchanged."""
    a = np.asarray(a)
    if (a.dtype.kind in "iu" and a.dtype != np.int32
            and (a.size == 0 or int(a.max()) < 2 ** 31)):
        return a.astype(np.int32)
    return a
