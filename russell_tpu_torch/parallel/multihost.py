"""Process-group set-up and the BANDED/BCR factorization split over ranks.

Counterpart of ``russell_tpu.parallel.multihost``. Where the reference
joins hosts with ``jax.distributed`` and lets GSPMD split BCR's block
axis, the port joins one process per rank with
``torch.distributed.init_process_group`` and splits each BCR level's
lanes over the ranks itself (``bcr.bcr_factorize`` with a split).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from russell_tpu_torch.parallel.mesh import MeshAxis
from russell_tpu_torch.sparse import factor as _factor

__all__ = ["initialize_multihost", "shard_banded_factorize",
           "shard_banded_solve"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         init_method: Optional[str] = None,
                         backend: Optional[str] = None,
                         device=None) -> None:
    """Join this process to the group of ``num_processes`` ranks as rank
    ``process_id`` (``torch.distributed.init_process_group``); a no-op when
    a group already exists.

    The rendezvous is ``init_method`` ("tcp://host:port", "file:///path"
    or "env://"), else "tcp://``coordinator_address``", else, for one
    process, a store in this process. ``backend`` defaults to "nccl"
    on the card and to "gloo" only for ``device="cpu"``; it is never
    switched on the caller's behalf. On the card, the rank's CUDA device
    (``LOCAL_RANK``, else ``process_id``, modulo the visible cards)
    becomes current; without a card it raises unless ``device="cpu"``."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_multihost: no CUDA device; pass "
                           "device='cpu' for a group of CPU ranks")
    if dist.is_initialized():
        return
    if backend is None:
        backend = "gloo" if kind == "cpu" else "nccl"
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if init_method is None:
        if world != 1:
            raise ValueError("initialize_multihost: more than one process "
                             "needs a coordinator_address or init_method")
        kw["store"] = dist.HashStore()
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)


def shard_banded_factorize(mesh, plan, data, axis: str = "rows"):
    """BANDED numeric factorization through cyclic reduction with each
    level's lanes split over the ranks of ``mesh``'s ``axis`` (where their
    count divides the ranks), D_o^{-1} F_o and D_o^{-1} E_o all-gathered
    for the neighbour shifts, and log|det|, sign and min|pivot| summed
    over the ranks in rank order. ``data``: the entry values (numpy or a
    tensor). Every rank returns the statistics; each split level holds
    this rank's lanes. Solve with ``shard_banded_solve``."""
    if not plan.use_bcr:
        raise ValueError("distributed factorization requires the BCR kernel "
                         "(analyze(..., banded_kernel='bcr'))")
    ax = MeshAxis(mesh, axis)
    return _factor._banded_factorize_bcr(
        plan, torch.as_tensor(data, device=ax.device), split=ax)


def shard_banded_solve(mesh, plan, fac, b, axis: str = "rows"):
    """Solve with ``shard_banded_factorize``'s factors, with the plan's
    rounds of iterative refinement as ``factor.factor_solve``; every rank
    returns x whole."""
    ax = MeshAxis(mesh, axis)
    b = torch.as_tensor(b, device=ax.device)
    x = _factor._banded_solve_bcr(plan, fac, b, split=ax)
    for _ in range(plan.refine_steps):
        x = x + _factor._banded_solve_bcr(
            plan, fac, _factor._residual(plan, fac, x, b), split=ax)
    return x
