"""Distributed GRIDMF: the regular-grid multifrontal factorization with
each depth's node axis split over the ranks.

Counterpart of ``russell_tpu.parallel.dist_gridmf``. The elimination tree
of the padded grid is balanced, so every depth is one batched pipeline
over n_nodes = 2^d congruent fronts. Where the ranks divide n_nodes, rank
r takes the node block [a, b); the children 2i, 2i+1 of its parents are
the block [2a, 2b), its own, so the extend-add moves nothing. At the
first depth going up that the ranks do not divide, the children's Schur
complements are all-gathered and the rest runs on every rank. The math
is ``gridmf_factorize``'s; the split depths' statistics are summed over
the ranks in rank order (``gridmf.gridmf_factorize`` with a split).
"""

from __future__ import annotations

import torch

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse.gridmf import (GridMfPlan, gridmf_factorize,
                                             gridmf_solve)

__all__ = ["dist_gridmf_factorize", "dist_gridmf_solve"]


def dist_gridmf_factorize(mesh, plan: GridMfPlan, data, axis: str = "rows"):
    """Numeric GRIDMF factorization with each depth's fronts split
    blockwise over the ranks of ``mesh``'s ``axis``. ``data``: the entry
    values (numpy or a tensor). Returns ``gridmf_factorize``'s fac, each
    depth holding this rank's block and ``ranges`` each depth's node range
    (None: every node); logdet, phase, min_pivot and n_perturbed are
    whole on every rank. Solve with ``dist_gridmf_solve``."""
    ax = MeshAxis(mesh, axis)
    return gridmf_factorize(plan, torch.as_tensor(data, device=ax.device),
                            split=ax)


def dist_gridmf_solve(mesh, plan: GridMfPlan, fac, b, axis: str = "rows"):
    """Up- and down-sweeps over ``dist_gridmf_factorize``'s factors with
    the same node split; every rank returns x whole."""
    ax = MeshAxis(mesh, axis)
    return gridmf_solve(plan, fac, torch.as_tensor(b, device=ax.device),
                        split=ax)
