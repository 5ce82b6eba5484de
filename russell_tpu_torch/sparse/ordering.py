"""Host-side orderings for the native factorizations.

The reference delegates ordering to its backends (AMD/COLAMD/METIS etc.,
russell_sparse/src/enums.rs:71-158). The *symbolic* phase runs on the host
(it is pointer-chasing, not FLOPs) and produces a static permutation that
shapes the numeric factorization:

- RCM (reverse Cuthill-McKee) minimizes bandwidth, feeding the
  block-tridiagonal factorization (Genie.BANDED)
- ND (nested dissection) gives SPLU a low-depth elimination tree
- MINDEG (approximate minimum degree flavor) minimizes fill for Genie.SPLU

Pure NumPy, copied from ``russell_tpu.sparse.ordering`` so that both
packages build identical plans; the C++ engine in ``russell_tpu_torch.native``
(the same ``symbolic.cpp``) replaces these transparently (same outputs).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rcm_ordering", "mindeg_ordering", "nd_ordering", "bandwidth",
           "symmetrize_pattern", "idx32", "rank_passes", "segment_index"]


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


def bandwidth(rows, cols, perm=None) -> int:
    """Max |perm[i]-perm[j]| over the nonzero pattern (0 for diagonal)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) == 0:
        return 0
    if perm is not None:
        iperm = np.empty(len(perm), dtype=np.int64)
        iperm[perm] = np.arange(len(perm))
        rows = iperm[rows]
        cols = iperm[cols]
    return int(np.max(np.abs(rows - cols)))


def rcm_ordering(n, rows, cols) -> np.ndarray:
    """Reverse Cuthill-McKee: returns ``perm`` with new_index = position of
    old index in ``perm`` (i.e. A_new = A[perm][:, perm]).

    Uses the native C++ engine when available (russell_tpu_torch.native)."""
    from russell_tpu_torch import native
    nat = native.rcm_order(n, rows, cols)
    if nat is not None:
        return nat
    indptr, adj = symmetrize_pattern(n, rows, cols)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # process every connected component
    remaining = np.argsort(degree, kind="stable")
    rem_idx = 0
    while pos < n:
        while rem_idx < n and visited[remaining[rem_idx]]:
            rem_idx += 1
        start = remaining[rem_idx]
        # BFS from a pseudo-peripheral-ish start (min degree in component)
        visited[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = adj[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return order[::-1].copy()  # reverse CM


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


def rank_passes(keys):
    """Entry ids grouped by duplicate rank: pass k holds the k-th entry (in
    entry order) of every key that has more than k entries. Each pass
    targets distinct keys, so a scatter-add per pass never races on the
    card, and the passes add a key's entries left to right, as a
    sequential scatter-add does: the same bits on every run and on the
    CPU as before."""
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    k_sorted = keys[order]
    starts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
    rank = np.arange(len(keys)) - np.repeat(starts, np.diff(
        np.r_[starts, len(keys)]))
    return [order[rank == k]
            for k in range(int(rank.max()) + 1 if len(keys) else 0)]


def segment_index(keys, n):
    """(order, offsets) of a segment sum over ``keys`` (``splu.segment_sum``):
    the entry ids sorted by key, in entry order within a key (None when
    the keys are already sorted), and the ``n + 1`` offsets of the ``n``
    keys' runs in that order."""
    keys = np.asarray(keys, dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=offsets[1:])
    if len(keys) < 2 or bool(np.all(keys[1:] >= keys[:-1])):
        return None, offsets
    return np.argsort(keys, kind="stable"), offsets
