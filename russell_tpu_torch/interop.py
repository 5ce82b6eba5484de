"""SPLU and GENMF plans, SPLU / DENSE / BANDED / GENMF factors, BSR
matrices and SpGEMM plans to and from the reference package's.

``russell_tpu`` (JAX) is the reference this package is held against.
These helpers carry a SPLU plan and a SPLU factorization, a BSR matrix and
a SpGEMM plan across, as plain numpy arrays, so that both packages can be
fed the same objects. They never import either package's framework
objects: an object from ``russell_tpu`` is read by its attributes, and one
for it is returned as the keyword arguments of its dataclass.

A SPLU factor dict holds ``blocks`` (K-embedding layout for complex
matrices), ``logdet``, ``min_pivot``, ``n_perturbed``, ``phase`` and, when
it came from ``factor``, ``rs``, ``cs`` and ``data``. A DENSE factor dict
holds ``lu``, ``piv``, ``rs``, ``cs``, ``logdet``, ``phase``,
``min_pivot`` and ``data``; its ``piv`` is 0-based in the reference
package (``jax.scipy.linalg.lu_factor``) and 1-based here
(``torch.linalg.lu_factor_ex``), and the converters shift it.

A BANDED factor dict (the sequential scan: ``lus``, ``pivs``, ``Cs``,
``E``; block cyclic reduction: ``levels``, a list of dicts of ``lus``,
``pivs``, ``Ee``, ``Fe``, ``Eo``, ``Fo``, and ``root``, a dict of ``lus``
and ``pivs``) and a GENMF factor dict (``classes``, a list of dicts of
the planes ``sir``, ``sii``, ``lr``, ``li``, ``br``, ``bi``, each possibly
None) are nested: ``tree_to_torch`` / ``tree_to_numpy`` carry them across
whole, shifting every ``piv`` / ``pivs`` between 0- and 1-based.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.sparse.kernels import (BsrMatrix, SpgemmPlan, _c_ptr,
                                              bsr_from_arrays)
from russell_tpu_torch.sparse.genmf import GenMfPlan, _GClass, _GLink
from russell_tpu_torch.sparse.splu import SpluPlan

__all__ = ["splu_plan_from", "splu_plan_fields", "factor_to_torch",
           "factor_to_numpy", "dense_factor_to_torch", "dense_factor_to_numpy",
           "genmf_plan_fields", "genmf_plan_from", "tree_to_torch",
           "tree_to_numpy", "bsr_fields", "bsr_from", "spgemm_plan_from"]


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


def factor_to_torch(fac: dict, device="cuda") -> dict:
    """A SPLU factor dict of numpy arrays (or anything ``np.asarray``
    reads) as tensors on ``device``, in the dtypes this package uses."""
    device = russell_tpu_torch.device(device)
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


def dense_factor_to_torch(fac: dict, device="cuda") -> dict:
    """A DENSE factor dict of numpy arrays with the reference package's
    0-based ``piv`` as tensors on ``device``, ``piv`` 1-based int32."""
    out = factor_to_torch({k: v for k, v in fac.items() if k != "piv"},
                          device)
    out["piv"] = torch.as_tensor(
        np.asarray(fac["piv"]).astype(np.int32) + 1, device=out["lu"].device)
    return out


def dense_factor_to_numpy(fac: dict) -> dict:
    """A DENSE factor dict of tensors as numpy arrays on the host, ``piv``
    0-based as in the reference package."""
    out = factor_to_numpy(fac)
    out["piv"] = out["piv"] - 1
    return out


def genmf_plan_fields(plan) -> dict:
    """The fields of a GENMF plan (either package's) as keyword arguments
    for either package's ``GenMfPlan``; ``classes`` becomes a list of dicts
    (the fields of each class, its ``links`` a list of dicts of the
    fields of each link), arrays as numpy."""
    def fields(obj, cls):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}

    out = fields(plan, GenMfPlan)
    classes = []
    for c in plan.classes:
        d = fields(c, _GClass)
        d["links"] = [fields(link, _GLink) for link in c.links]
        classes.append(d)
    out["classes"] = classes
    return out


def genmf_plan_from(plan) -> GenMfPlan:
    """This package's ``GenMfPlan`` with the fields of ``plan`` (e.g. one
    made by ``russell_tpu.sparse.genmf.genmf_analyze``)."""
    f = genmf_plan_fields(plan)
    f["classes"] = [_GClass(**{**c, "links": [_GLink(**link)
                                              for link in c["links"]]})
                    for c in f["classes"]]
    return GenMfPlan(**f)


_PIVOTS = ("piv", "pivs")


def tree_to_torch(obj, device="cuda"):
    """A factor dict of numpy arrays (or anything ``np.asarray`` reads),
    nested in dicts and lists with None leaves, as tensors on ``device``
    in this package's dtypes; ``piv`` / ``pivs`` 1-based int32."""
    device = russell_tpu_torch.device(device)

    def conv(v, key=None):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        a = np.asarray(v)
        if key in _PIVOTS:
            a = a.astype(np.int32) + 1
        elif key == "n_perturbed":
            a = a.astype(np.int32)
        elif a.dtype.kind == "f":
            a = a.astype(np.float64)
        elif a.dtype.kind == "c":
            a = a.astype(np.complex128)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return conv(obj)


def tree_to_numpy(obj):
    """A nested factor dict of tensors as numpy arrays on the host, with
    ``piv`` / ``pivs`` 0-based as in the reference package."""
    def conv(v, key=None):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        a = v.detach().cpu().numpy()
        return a - 1 if key in _PIVOTS else a

    return conv(obj)


def _host(v):
    """A writable host copy of ``v`` (a tensor or anything numpy reads)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.array(v)


def bsr_fields(bsr) -> dict:
    """The fields of a BSR matrix (either package's), its arrays as numpy
    on the host: keyword arguments for either package's ``BsrMatrix``."""
    out = {}
    for f in dataclasses.fields(BsrMatrix):
        v = getattr(bsr, f.name)
        out[f.name] = v if isinstance(v, int) else _host(v)
    return out


def bsr_from(bsr, device="cuda") -> BsrMatrix:
    """This package's ``BsrMatrix`` on ``device`` with the arrays of ``bsr``
    (e.g. one made by ``russell_tpu.sparse.kernels.bsr_from_coo``)."""
    f = bsr_fields(bsr)
    return bsr_from_arrays(f["n_rows"], f["n_cols"], f["bm"], f["bn"],
                           f["blocks"], f["col_ids"], f["mask"], device)


def spgemm_plan_from(plan) -> SpgemmPlan:
    """This package's ``SpgemmPlan`` with the arrays of ``plan`` (e.g. one
    made by ``russell_tpu.sparse.kernels.spgemm_plan``); its ``c_ptr`` is
    built from the sorted ``c_idx``."""
    c_idx = np.asarray(plan.c_idx, dtype=np.int64)
    return SpgemmPlan(
        n=plan.n, b=plan.b, a_idx=np.asarray(plan.a_idx, dtype=np.int64),
        b_idx=np.asarray(plan.b_idx, dtype=np.int64), c_idx=c_idx,
        c_ptr=_c_ptr(c_idx, plan.c_blocks),
        c_blocks=plan.c_blocks, c_block_ij=np.asarray(plan.c_block_ij))
