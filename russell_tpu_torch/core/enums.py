"""Base enums (reference: russell_lab/src/base/enums.rs:5).

Counterpart of ``russell_tpu.core.enums``. The norms follow the device
rule (``core/_place.py``): a tensor's own device, else ``device=``.
"""

from __future__ import annotations

import enum

import torch

from russell_tpu_torch.core._place import on

__all__ = ["Norm", "vec_norm", "mat_norm"]


class Norm(enum.Enum):
    """Norm selector, matching russell_lab's ``Norm`` enum.

    - ``ONE``:  1-norm; for matrices, max absolute column sum
    - ``EUC``:  Euclidean norm (vectors)
    - ``FRO``:  Frobenius norm (matrices; == EUC for vectors)
    - ``INF``:  infinity norm; for matrices, max absolute row sum
    - ``MAX``:  largest absolute entry
    """

    ONE = "one"
    EUC = "euc"
    FRO = "fro"
    INF = "inf"
    MAX = "max"


def vec_norm(v, norm: Norm = Norm.EUC, device=None):
    """Vector norm (russell_lab vector/vec_norm.rs:7-15): a 0-dim tensor.
    INF and MAX of an empty vector are 0.0, as in the reference."""
    (v,) = on(v, device=device)
    a = torch.abs(v)
    if norm == Norm.ONE:
        return torch.sum(a)
    if norm in (Norm.EUC, Norm.FRO):
        return torch.linalg.vector_norm(v)
    if norm in (Norm.INF, Norm.MAX):
        return torch.max(a) if v.numel() else torch.zeros(
            (), dtype=a.dtype, device=a.device)
    raise ValueError(f"unknown norm {norm}")


def mat_norm(m, norm: Norm = Norm.FRO, device=None):
    """Matrix norm (russell_lab matrix/mat_norm.rs): a 0-dim tensor."""
    (m,) = on(m, device=device)
    a = torch.abs(m)
    if norm == Norm.ONE:
        return torch.max(torch.sum(a, dim=0))
    if norm == Norm.INF:
        return torch.max(torch.sum(a, dim=1))
    if norm in (Norm.EUC, Norm.FRO):
        return torch.linalg.vector_norm(m)
    if norm == Norm.MAX:
        return torch.max(a)
    raise ValueError(f"unknown norm {norm}")
