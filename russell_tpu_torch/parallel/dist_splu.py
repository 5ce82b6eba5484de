"""Distributed sparse LU: the packed left-looking SPLU numeric phase with
each scan row's contribution pairs split over the ranks.

Counterpart of ``russell_tpu.parallel.dist_splu``, the same distribution
of the work: every scan row's Schur contribution pairs (Lhat_im @ A_mj
products feeding one contiguous storage range) are cut into one run per
rank, each rank sums its run with the ``splu_pairs`` kernel (under a chunk
schedule of its own, ``splu._rank_pairs``, built once per plan and rank),
and one ``all_reduce`` per row makes the sum whole. That is a true sum,
the single-device one up to the order of its addends. The rest of the row
(the diagonal inversion with ``gj_inv``, the panel products with
``gather_rows``) runs alike on every rank, so every rank returns the
factorization ``splu_factorize`` returns, fit for ``splu_solve``.

Where the reference turns its Pallas pair kernel off under sharding, the
port keeps its kernel: ``splu_pairs`` takes any slice of a row's pairs.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse import splu as _splu
from russell_tpu_torch.sparse.splu import SpluPlan

__all__ = ["dist_splu_factorize"]


def dist_splu_factorize(mesh, plan: SpluPlan, data, axis: str = "rows"):
    """Numeric SPLU with each scan row's contribution pairs split over the
    ranks of ``mesh``'s ``axis``. ``data``: the entry values (numpy or a
    tensor, f64 or complex128). Returns the dict of ``splu_factorize``
    (blocks, logdet, phase, min_pivot, n_perturbed) on every rank."""
    ax = MeshAxis(mesh, axis)
    data = torch.as_tensor(data, device=ax.device)
    if data.dim() != 1:
        raise ValueError(f"dist_splu_factorize takes one matrix's entries "
                         f"(nnz,), got {tuple(data.shape)}")
    dp = _splu._device_plan(plan, data.device)
    states, deltas, cplxs = _splu._init_states(plan, (data,), dp)
    pairs = _splu._rank_pairs(plan, data.device, ax.world, ax.rank)
    state, = _splu._scan_packed(plan, states, deltas, cplxs, dp,
                                pairs=pairs, reduce=ax.reduce)
    return _splu._fac_dict(state, False)
