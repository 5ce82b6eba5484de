"""SPLU plans and factors to and from the reference package's.

``russell_tpu`` (JAX) is the reference this package is held against.
These helpers carry a SPLU plan and a SPLU factorization across, as plain
numpy arrays, so that a factorization made by one package can be solved
by the other. They never import either package's framework objects: a
plan from ``russell_tpu`` is read by its attributes, and one for it is
returned as the keyword arguments of its ``SpluPlan``.

A SPLU factor dict holds ``blocks`` (K-embedding layout for complex
matrices), ``logdet``, ``min_pivot``, ``n_perturbed``, ``phase`` and, when
it came from ``factor``, ``rs``, ``cs`` and ``data``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from russell_tpu_torch.sparse.splu import SpluPlan

__all__ = ["splu_plan_from", "splu_plan_fields", "factor_to_torch",
           "factor_to_numpy"]


def splu_plan_fields(plan) -> dict:
    """The fields of a SPLU plan (either package's) as keyword arguments
    for either package's ``SpluPlan``; ``packed`` is copied without the
    private caches either package keeps in it or on the plan."""
    out = {}
    for f in dataclasses.fields(SpluPlan):
        v = getattr(plan, f.name)
        if f.name == "packed" and v is not None:
            v = {k: (dict(pv) if isinstance(pv, dict) else pv)
                 for k, pv in v.items() if not k.startswith("_")}
        out[f.name] = v
    return out


def splu_plan_from(plan) -> SpluPlan:
    """This package's ``SpluPlan`` with the fields of ``plan`` (e.g. one
    made by ``russell_tpu.sparse.splu.splu_analyze``)."""
    return SpluPlan(**splu_plan_fields(plan))


def factor_to_torch(fac: dict, device="cpu") -> dict:
    """A SPLU factor dict of numpy arrays (or anything ``np.asarray``
    reads) as tensors on ``device``, in the dtypes this package uses."""
    out = {}
    for k, v in fac.items():
        a = np.asarray(v)
        if k == "n_perturbed":
            a = a.astype(np.int32)
        elif a.dtype.kind == "f":
            a = a.astype(np.float64)
        elif a.dtype.kind == "c":
            a = a.astype(np.complex128)
        out[k] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return out


def factor_to_numpy(fac: dict) -> dict:
    """A SPLU factor dict of tensors as numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in fac.items()}
