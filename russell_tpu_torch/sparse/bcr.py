"""Block cyclic reduction (BCR) for block-tridiagonal systems, in PyTorch.

Counterpart of ``russell_tpu.sparse.bcr``. The sequential banded kernel
(factor.py BANDED) steps over nb block rows one after the other. BCR
restructures the elimination into ceil(log2(nb)) *levels*; within a level
every block operation is independent, so each level is one **batched**
LU / triangular solve / GEMM (``lu_factor`` and ``lu_solve`` over
``torch.linalg``, and batched matmuls, as the reference package calls
``jax.scipy.linalg``), and neighbour access is a shift.

Scheme (eliminate odd block rows per level):
  D'_i = D_i - Gl_i F_{i-1} - Hr_i E_{i+1}
  E'_i = -Gl_i E_{i-1}
  F'_i = -Hr_i F_{i+1}          with  Gl_i = E_i D_{i-1}^{-1},
                                      Hr_i = F_i D_{i+1}^{-1}
  b'_i = b_i - Gl_i b_{i-1} - Hr_i b_{i+1}
Back-substitution per level (reverse): odd rows solved from their even
neighbours. Diagonal LUs use local partial pivoting + static perturbation;
factor.py wraps BCR with equilibration and iterative refinement.

Pivots are ``torch.linalg``'s, 1-based (the reference package's are
0-based).

The block arrays may carry leading lane dimensions (a batch of matrices
of one pattern): D, E, F (..., nb, k, k) and right-hand sides (..., nb,
k). Each level's odd blocks of every lane then go into one batched LU,
with one pivot threshold per matrix.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

__all__ = ["bcr_factorize", "bcr_solve", "bcr_levels", "lu_static",
           "lu_factor", "lu_perm", "lu_solve"]


def bcr_levels(nb: int) -> int:
    return max(1, math.ceil(math.log2(max(nb, 2))))


def _pad_pow2(D, E, F):
    """Pad the block arrays to a power-of-two count with identity blocks."""
    lead, nb, k = D.shape[:-3], D.shape[-3], D.shape[-1]
    M = 1 << bcr_levels(nb)
    if M == nb:
        return D, E, F, nb
    eye = torch.eye(k, dtype=D.dtype, device=D.device).expand(
        lead + (M - nb, k, k))
    zero = D.new_zeros(lead + (M - nb, k, k))
    return (torch.cat([D, eye], dim=-3), torch.cat([E, zero], dim=-3),
            torch.cat([F, zero], dim=-3), nb)


# torch's choice of linear algebra library is one setting of the process
_LIBRARY = threading.Lock()


@contextlib.contextmanager
def _cusolver(t):
    """cuSOLVER as torch's linear algebra library while a CUDA ``t``'s
    factors are made: its looped getrf and cuBLAS's batched getrf replay
    inside a CUDA graph's conditional bodies, where MAGMA's batched LU,
    which torch's heuristic takes for more than 16 blocks above 128 x
    128, does not. Every factorization on the card takes it, captured or
    not, so a fused run and a host-stepped one give the same bits. The
    setting is the process's: ``_LIBRARY`` keeps two threads from
    restoring each other's, and another thread's ``torch.linalg`` call
    made meanwhile runs through cuSOLVER too."""
    if t.device.type != "cuda":
        yield
        return
    with _LIBRARY:
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            yield
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)


def lu_factor(A):
    """Batched LU with partial pivoting of A (..., k, k): (lu, piv), as
    ``torch.linalg.lu_factor_ex`` gives them, through cuSOLVER on the
    card (``_cusolver``)."""
    with _cusolver(A):
        lu, piv, _ = torch.linalg.lu_factor_ex(A)
    return lu, piv


def lu_perm(lu, piv):
    """The row order of LU factors (..., k, k) and their 1-based pivots
    (..., k): int64 (..., k), row i of P^T B being row perm[i] of B (A = P
    L U). Made once with the factors, so that a solve is a gather and two
    triangular solves."""
    P = torch.lu_unpack(lu, piv, unpack_data=False)[0]
    # P[perm[i], i] = 1
    return P.real.argmax(dim=-2)


def lu_solve(lu, perm, B):
    """X = A^{-1} B from ``lu_factor``'s factors of A (..., k, k) and their
    ``lu_perm``, B (..., k, r) with the same batch: the rows of B in the
    pivots' order, then the two triangular solves.
    ``torch.linalg.lu_solve`` of one matrix against one column takes
    cuSOLVER's getrs, which does not replay inside a CUDA graph's
    conditional body; the gather and cuBLAS's trsm do."""
    PB = torch.gather(B, -2, perm[..., None].expand(B.shape))
    Y = torch.linalg.solve_triangular(lu, PB, upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, Y, upper=True)


def lu_static(D, delta):
    """Batched LU with static pivot perturbation on tiny pivots: every
    lane whose smallest |U pivot| is <= ``delta`` is factorized again as
    D + delta I (the reference's per-lane ``lax.cond``). Both LUs run for
    every lane and ``torch.where`` picks, so no value is read back to the
    host. ``delta`` is one value, or one per matrix of a batch: shape
    D.shape[:-3] for lanes D (..., m, k, k). Returns (lu, piv, perm,
    perturbed lanes), ``perm`` the chosen factors' ``lu_perm``."""
    if delta.dim():
        delta = delta[..., None]        # over each matrix's m blocks
    lu, piv = lu_factor(D)
    bad = (torch.diagonal(lu, dim1=-2, dim2=-1).abs().amin(dim=-1)
           <= delta)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    lu2, piv2 = lu_factor(D + delta[..., None, None].to(D.dtype) * eye)
    lu = torch.where(bad[..., None, None], lu2, lu)
    piv = torch.where(bad[..., None], piv2, piv)
    return lu, piv, lu_perm(lu, piv), bad


def _apply_inv(lus, perms, B):
    """X = D^{-1} B for batched LU factors and batched B (m, k, k) or
    vectors (m, k)."""
    if B.dim() == lus.dim() - 1:
        return lu_solve(lus, perms, B.unsqueeze(-1)).squeeze(-1)
    return lu_solve(lus, perms, B)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _shift_right(a, dim):
    """a[q - 1] at q along ``dim``, zero at 0 (jnp.roll(a, 1).at[0]
    .set(0))."""
    return torch.cat([torch.zeros_like(a.narrow(dim, 0, 1)),
                      a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def _shift_left(a, dim):
    """a[q + 1] at q along ``dim``, zero at the end (jnp.roll(a, -1)
    .at[-1].set(0))."""
    return torch.cat([a.narrow(dim, 1, a.shape[dim] - 1),
                      torch.zeros_like(a.narrow(dim, 0, 1))], dim=dim)


def _lanes(split, n):
    """This rank's lanes [a, b) of a level's n odd rows, or None (every
    lane, on every rank) without ``split`` or when it does not divide n."""
    return None if split is None else split.block(n)


def _inv_lanes(split, rng, lus, perms, B):
    """D_o^{-1} B over every lane: this rank's lanes of B solved and
    all-gathered when the level is split."""
    if rng is None:
        return _apply_inv(lus, perms, B)
    return split.gather(_apply_inv(lus, perms, B[rng[0]:rng[1]]))


def bcr_factorize(D, E, F, pivot_epsilon: float = 1e-14, split=None):
    """Factorize the block-tridiagonal system (D diag, E sub, F super).

    Returns a dict ``fac`` holding per-level transformed operators:
    everything ``bcr_solve`` needs, with log2(nb) levels of batched
    factorizations.

    ``split`` (``parallel.mesh.MeshAxis``) spreads each level whose odd
    row count it divides over the ranks: this rank factorizes its lanes
    [a, b) of the odd diagonal blocks (kept in the level with ``range``)
    and solves them against F_o and E_o, and D_o^{-1} F_o and D_o^{-1} E_o
    are all-gathered for the neighbour shifts; the even rows' update runs
    on every rank. min|pivot| is taken over the ranks.

    Blocks with leading lane dimensions (a batch) factorize every matrix
    at once, each with its own pivot threshold and min|pivot|; a batch
    takes no ``split``."""
    lead = D.shape[:-3]
    if lead and split is not None:
        raise ValueError(f"BCR: a split factorization takes one matrix, "
                         f"got blocks {tuple(D.shape)}")
    delta = pivot_epsilon * (1.0 + D.abs().amax(dim=(-3, -2, -1)))
    D, E, F, nb = _pad_pow2(D, E, F)
    levels = []
    odd = (Ellipsis, slice(1, None, 2), slice(None), slice(None))
    even = (Ellipsis, slice(0, None, 2), slice(None), slice(None))
    while D.shape[-3] > 1:
        Do, Eo, Fo = D[odd], E[odd], F[odd]         # odd rows (eliminated)
        De, Ee, Fe = D[even], E[even], F[even]      # even rows (kept)
        rng = _lanes(split, Do.shape[-3])
        lus, pivs, perms, _ = lu_static(
            Do if rng is None else Do[rng[0]:rng[1]], delta)
        # Gl_i = E_i D_{i-1}^{-1}: D_{i-1} is odd block (i//2 - 1)
        DinvF = _inv_lanes(split, rng, lus, perms, Fo)  # D_o^{-1} F_o
        DinvE = _inv_lanes(split, rng, lus, perms, Eo)  # D_o^{-1} E_o
        # for even index q (block 2q): left odd is q-1, right odd is q
        D_new = De - Ee @ _shift_right(DinvF, -3) - Fe @ DinvE
        E_new = -(Ee @ _shift_right(DinvE, -3))
        F_new = -(Fe @ DinvF)
        level = {"lus": lus, "pivs": pivs, "perms": perms, "Ee": Ee,
                 "Fe": Fe, "Eo": Eo, "Fo": Fo}
        if split is not None:
            level["range"] = rng
        levels.append(level)
        D, E, F = D_new, E_new, F_new
    lus, pivs, perms, _ = lu_static(D, delta)
    root = {"lus": lus, "pivs": pivs, "perms": perms}
    mp = torch.diagonal(lus, dim1=-2, dim2=-1).abs().amin(dim=(-2, -1))
    for lv in levels:
        mp_lv = torch.diagonal(lv["lus"], dim1=-2, dim2=-1).abs().amin(
            dim=(-2, -1))
        if lv.get("range") is not None:
            mp_lv = split.combine(min_pivot=mp_lv)["min_pivot"]
        mp = torch.minimum(mp, mp_lv)
    return {"levels": levels, "root": root, "min_pivot": mp}


def bcr_solve(fac, bp, split=None):
    """Solve with a bcr_factorize result; ``bp`` is (..., nb, k), with the
    factors' lane dimensions. Factors made with a ``split`` are solved
    with the same one: each split level's odd rows are solved on this
    rank's lanes and all-gathered."""
    lead, (nb, k) = bp.shape[:-2], bp.shape[-2:]
    root = fac["root"]["lus"]
    levels = fac["levels"]
    want = [None if split is None else _lanes(split, lv["Eo"].shape[-3])
            for lv in levels]
    if [lv.get("range") for lv in levels] != (
            want if split is not None else [None] * len(levels)):
        raise ValueError("the factors' lanes are not this solve's: solve "
                         "split factors with the split they were made with")
    M = 2 * levels[0]["Eo"].shape[-3] if levels else 1
    b = root.new_zeros(lead + (M, k))
    b[..., :nb, :] = bp.to(root.dtype)

    # forward reduction
    bs = []
    for lv in levels:
        bo = b[..., 1::2, :]
        be = b[..., 0::2, :]
        y = _inv_lanes(split, lv.get("range"), lv["lus"], lv["perms"],
                       bo)                            # D_o^{-1} b_o
        b_new = (be - _mv(lv["Ee"], _shift_right(y, -2))
                 - _mv(lv["Fe"], y))
        bs.append(bo)
        b = b_new

    # root solve
    x = _apply_inv(fac["root"]["lus"], fac["root"]["perms"], b)

    # back-substitution
    for lv, bo in zip(reversed(levels), reversed(bs)):
        xe = x                                        # even rows, known
        rhs = bo - _mv(lv["Eo"], xe) - _mv(lv["Fo"], _shift_left(xe, -2))
        xo = _inv_lanes(split, lv.get("range"), lv["lus"], lv["perms"],
                        rhs)
        x = torch.stack([xe, xo], dim=-2).reshape(lead + (-1, k))
    return x[..., :nb, :]
