"""Block cyclic reduction (BCR) for block-tridiagonal systems, in PyTorch.

Counterpart of ``russell_tpu.sparse.bcr``. The sequential banded kernel
(factor.py BANDED) steps over nb block rows one after the other. BCR
restructures the elimination into ceil(log2(nb)) *levels*; within a level
every block operation is independent, so each level is one **batched**
LU / triangular solve / GEMM (``torch.linalg.lu_factor_ex``, ``lu_solve``
and batched matmuls, as the reference package calls
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
"""

from __future__ import annotations

import math

import torch

__all__ = ["bcr_factorize", "bcr_solve", "bcr_levels", "lu_static"]


def bcr_levels(nb: int) -> int:
    return max(1, math.ceil(math.log2(max(nb, 2))))


def _pad_pow2(D, E, F):
    """Pad the block arrays to a power-of-two count with identity blocks."""
    nb, k, _ = D.shape
    M = 1 << bcr_levels(nb)
    if M == nb:
        return D, E, F, nb
    eye = torch.eye(k, dtype=D.dtype, device=D.device).expand(M - nb, k, k)
    zero = D.new_zeros((M - nb, k, k))
    return (torch.cat([D, eye]), torch.cat([E, zero]),
            torch.cat([F, zero]), nb)


def lu_static(D, delta):
    """Batched LU with static pivot perturbation on tiny pivots: every
    lane whose smallest |U pivot| is <= ``delta`` is factorized again as
    D + delta I (the reference's per-lane ``lax.cond``). Both LUs run for
    every lane and ``torch.where`` picks, so no value is read back to the
    host. Returns (lu, piv, perturbed lanes)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(D)
    bad = (torch.diagonal(lu, dim1=-2, dim2=-1).abs().amin(dim=-1)
           <= delta)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    lu2, piv2, _ = torch.linalg.lu_factor_ex(D + delta.to(D.dtype) * eye)
    return (torch.where(bad[..., None, None], lu2, lu),
            torch.where(bad[..., None], piv2, piv), bad)


def _apply_inv(lus, pivs, B):
    """X = D^{-1} B for batched LU factors and batched B (m, k, k) or
    vectors (m, k)."""
    if B.dim() == lus.dim() - 1:
        return torch.linalg.lu_solve(lus, pivs, B.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.lu_solve(lus, pivs, B)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _shift_right(a):
    """a[q - 1] at q, zero at 0 (jnp.roll(a, 1).at[0].set(0))."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]])


def _shift_left(a):
    """a[q + 1] at q, zero at the end (jnp.roll(a, -1).at[-1].set(0))."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])])


def _lanes(split, n):
    """This rank's lanes [a, b) of a level's n odd rows, or None (every
    lane, on every rank) without ``split`` or when it does not divide n."""
    return None if split is None else split.block(n)


def _inv_lanes(split, rng, lus, pivs, B):
    """D_o^{-1} B over every lane: this rank's lanes of B solved and
    all-gathered when the level is split."""
    if rng is None:
        return _apply_inv(lus, pivs, B)
    return split.gather(_apply_inv(lus, pivs, B[rng[0]:rng[1]]))


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
    on every rank. min|pivot| is taken over the ranks."""
    delta = pivot_epsilon * (1.0 + D.abs().max())
    D, E, F, nb = _pad_pow2(D, E, F)
    levels = []
    while D.shape[0] > 1:
        Do, Eo, Fo = D[1::2], E[1::2], F[1::2]      # odd rows (eliminated)
        De, Ee, Fe = D[0::2], E[0::2], F[0::2]      # even rows (kept)
        rng = _lanes(split, Do.shape[0])
        lus, pivs, _ = lu_static(Do if rng is None else Do[rng[0]:rng[1]],
                                 delta)
        # Gl_i = E_i D_{i-1}^{-1}: D_{i-1} is odd block (i//2 - 1)
        DinvF = _inv_lanes(split, rng, lus, pivs, Fo)   # D_o^{-1} F_o
        DinvE = _inv_lanes(split, rng, lus, pivs, Eo)   # D_o^{-1} E_o
        # for even index q (block 2q): left odd is q-1, right odd is q
        D_new = De - Ee @ _shift_right(DinvF) - Fe @ DinvE
        E_new = -(Ee @ _shift_right(DinvE))
        F_new = -(Fe @ DinvF)
        level = {"lus": lus, "pivs": pivs, "Ee": Ee, "Fe": Fe,
                 "Eo": Eo, "Fo": Fo}
        if split is not None:
            level["range"] = rng
        levels.append(level)
        D, E, F = D_new, E_new, F_new
    lus, pivs, _ = lu_static(D, delta)
    root = {"lus": lus, "pivs": pivs}
    mp = torch.diagonal(lus, dim1=-2, dim2=-1).abs().amin()
    for lv in levels:
        mp_lv = torch.diagonal(lv["lus"], dim1=-2, dim2=-1).abs().amin()
        if lv.get("range") is not None:
            mp_lv = split.combine(min_pivot=mp_lv)["min_pivot"]
        mp = torch.minimum(mp, mp_lv)
    return {"levels": levels, "root": root, "min_pivot": mp}


def bcr_solve(fac, bp, split=None):
    """Solve with a bcr_factorize result; ``bp`` is (nb, k). Factors made
    with a ``split`` are solved with the same one: each split level's odd
    rows are solved on this rank's lanes and all-gathered."""
    nb, k = bp.shape
    root = fac["root"]["lus"]
    levels = fac["levels"]
    want = [None if split is None else _lanes(split, lv["Eo"].shape[0])
            for lv in levels]
    if [lv.get("range") for lv in levels] != (
            want if split is not None else [None] * len(levels)):
        raise ValueError("the factors' lanes are not this solve's: solve "
                         "split factors with the split they were made with")
    M = 2 * levels[0]["Eo"].shape[0] if levels else 1
    b = root.new_zeros((M, k))
    b[:nb] = bp.to(root.dtype)

    # forward reduction
    bs = []
    for lv in levels:
        bo = b[1::2]
        be = b[0::2]
        y = _inv_lanes(split, lv.get("range"), lv["lus"], lv["pivs"],
                       bo)                            # D_o^{-1} b_o
        b_new = be - _mv(lv["Ee"], _shift_right(y)) - _mv(lv["Fe"], y)
        bs.append(bo)
        b = b_new

    # root solve
    x = _apply_inv(fac["root"]["lus"], fac["root"]["pivs"], b)

    # back-substitution
    for lv, bo in zip(reversed(levels), reversed(bs)):
        xe = x                                        # even rows, known
        rhs = bo - _mv(lv["Eo"], xe) - _mv(lv["Fo"], _shift_left(xe))
        xo = _inv_lanes(split, lv.get("range"), lv["lus"], lv["pivs"], rhs)
        x = torch.stack([xe, xo], dim=1).reshape(-1, k)
    return x[:nb]
