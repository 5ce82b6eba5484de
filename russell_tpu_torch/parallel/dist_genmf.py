"""Distributed GENMF: the general-matrix multifrontal with each size
class's node axis split over the ranks.

Counterpart of ``russell_tpu.parallel.dist_genmf``. Every (depth, e_pad,
r_pad) class is one batched dense pipeline; where the ranks divide its
node count, rank r assembles, inverts and updates only its node block.
GENMF's extend-add links are arbitrary gathers, so a split class's Schur
complements (and, in the solve, its keep right-hand sides and front
solutions) are all-gathered before another class reads them; the classes
the ranks do not divide run on every rank. The math is
``genmf_factorize``'s; the split classes' statistics are summed over the
ranks in rank order.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse.genmf import (GenMfPlan, genmf_factorize,
                                            genmf_solve)

__all__ = ["dist_genmf_factorize", "dist_genmf_solve"]


def dist_genmf_factorize(mesh, plan: GenMfPlan, data, axis: str = "rows"):
    """Numeric GENMF factorization with each class's nodes split blockwise
    over the ranks of ``mesh``'s ``axis``. ``data``: the entry values
    (numpy or a tensor). Returns ``genmf_factorize``'s fac, each class
    holding this rank's block and ``ranges`` each class's node range
    (None: every node); the statistics are whole on every rank. Solve
    with ``dist_genmf_solve``."""
    ax = MeshAxis(mesh, axis)
    return genmf_factorize(plan, torch.as_tensor(data, device=ax.device),
                           split=ax)


def dist_genmf_solve(mesh, plan: GenMfPlan, fac, b, axis: str = "rows"):
    """Up- and down-sweeps over ``dist_genmf_factorize``'s factors with
    the same node split; every rank returns x whole."""
    ax = MeshAxis(mesh, axis)
    return genmf_solve(plan, fac, torch.as_tensor(b, device=ax.device),
                       split=ax)
