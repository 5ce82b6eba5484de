"""Data-parallel batched factorize-and-solve over the ranks.

Counterpart of ``russell_tpu.parallel.batch``. The reference shards the
batch axis of a vmapped factorize-and-solve over the mesh; here each rank
factorizes and solves its own rows of the batch in one batched numeric
phase and one batched solve over the plan (``factor.factor_solve_batch``,
every genie), and the solutions are all-gathered, so every rank returns
the whole batch.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse import factor as _factor

__all__ = ["batch_factor_solve"]


def batch_factor_solve(mesh, plan, batch_vals, batch_rhs,
                       axis: str = "rows"):
    """Solve A_i x_i = b_i for a batch of same-structure systems.

    ``batch_vals`` (B, nnz) entry values and ``batch_rhs`` (B, n), numpy
    or tensors, the whole batch on every rank; B must be a multiple of the
    ranks on ``mesh``'s ``axis``. Rank r factorizes and solves rows
    [r B/W, (r+1) B/W) in one batched numeric phase over the plan, as the
    reference's vmap does. Returns the (B, n) solutions on every rank."""
    ax = MeshAxis(mesh, axis)
    vals = torch.as_tensor(batch_vals, device=ax.device)
    rhs = torch.as_tensor(batch_rhs, device=ax.device)
    if vals.dim() != 2 or rhs.dim() != 2 or vals.shape[0] != rhs.shape[0]:
        raise ValueError(f"batch_vals (B, nnz) and batch_rhs (B, n) expected, "
                         f"got {tuple(vals.shape)} and {tuple(rhs.shape)}")
    B = vals.shape[0]
    rng = ax.block(B) if B else None
    if rng is None:
        raise ValueError(f"a batch of {B} does not split over {ax.world} "
                         "ranks")
    a, b = rng
    return ax.gather(_factor.factor_solve_batch(plan, vals[a:b], rhs[a:b]))
