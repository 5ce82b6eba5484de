"""Device meshes over the ranks of a ``torch.distributed`` group.

Counterpart of ``russell_tpu.parallel.mesh``. One process runs per rank
(SPMD), each on one device: ``make_mesh`` lays the group's ranks out as a
``DeviceMesh``, and ``MeshAxis`` is one of its axes seen from this rank:
the split of a batch or node axis into rank blocks and the collectives the
``dist_*`` functions run over it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "MeshAxis"]


def _device_type(device) -> str:
    """The mesh's device type: the card unless the caller asks for the
    CPU; raises without a card rather than run on the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for "
                           "a mesh of CPU ranks")
    return kind


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("rows",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over ranks 0 .. ``n_devices`` - 1 of the process
    group (every rank by default), laid out as ``shape`` with
    ``axis_names``. On "cuda" unless ``device`` is "cpu": each rank's
    device is the CUDA device ``initialize_multihost`` made current. Every
    rank of the group calls it. Raises the reference's ``ValueError``s
    (too many devices, a shape that does not match, names that do not
    match) and ``RuntimeError`` without a card (unless ``device="cpu"``)
    or without a process group."""
    kind = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_multihost first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if shape is None:
        shape = (n_devices,)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {tuple(shape)} != {n_devices} devices")
    if len(shape) != len(axis_names):
        raise ValueError("axis_names must match mesh shape rank")
    return DeviceMesh(kind, torch.arange(n_devices).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


class MeshAxis:
    """One axis of a mesh from this rank: its process group, this rank's
    index on it and its size, and this rank's device. Rank r of W owns
    block [r n/W, (r+1) n/W) of an axis of n items when W divides n
    (``block``); the collectives return the same bits on every rank:
    ``gather`` concatenates the ranks' tensors along dim 0 in rank order,
    and ``combine`` folds per-rank statistics in rank order. With one
    rank, each returns its input."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
        self.world = int(mesh.shape[names.index(axis)])
        self.rank = int(mesh.get_local_rank(axis))
        self.group = mesh.get_group(axis)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda"
                       else torch.device(mesh.device_type))

    def block(self, n: int):
        """This rank's block (a, b) of n items, or None when the ranks do
        not divide n (every rank then takes all n)."""
        if n % self.world:
            return None
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0 in
        rank order (the list form of ``all_gather``, which gloo also runs
        on CUDA tensors)."""
        if self.world == 1:
            return t
        src = (torch.view_as_real(t) if t.is_complex() else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return torch.view_as_complex(out) if t.is_complex() else out

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in place (``all_reduce``)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    _FOLDS = {"logdet": torch.add, "n_perturbed": torch.add,
              "min_pivot": torch.minimum, "phase": torch.mul}

    def combine(self, **stats):
        """Per-rank partial factorization statistics (0-dim tensors named
        logdet, min_pivot, n_perturbed or phase; a complex phase too) over
        every rank: one all-gather of them all, then each folded in rank
        order (sum, min, sum, product), so every rank holds the same bits.
        Returns a dict of the same names and dtypes."""
        if self.world == 1:
            return stats
        flat = torch.cat([torch.view_as_real(v).reshape(-1) if v.is_complex()
                          else v.reshape(1).to(torch.float64)
                          for v in stats.values()])
        rows = self.gather(flat[None])
        out, col = {}, 0
        for k, v in stats.items():
            if v.is_complex():
                vals = torch.view_as_complex(rows[:, col:col + 2].contiguous())
                col += 2
            else:
                vals = rows[:, col]
                col += 1
            acc = vals[0]
            for r in range(1, self.world):
                acc = self._FOLDS[k](acc, vals[r])
            out[k] = acc.to(v.dtype)
        return out
