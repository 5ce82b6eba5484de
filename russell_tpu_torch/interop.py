"""SPLU and GENMF plans, SPLU / DENSE / BANDED / GENMF factors, BSR
matrices, SpGEMM plans and continuation configurations and outputs to and
from the reference package's.

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
whole, shifting every ``piv`` / ``pivs`` between 0- and 1-based. This
package's DENSE and BANDED factors also hold the pivots' row order
(``perm``, ``perms``, from ``bcr.lu_perm``): the converters to it make
them, the converters from it drop them. An out-of-core GRIDMF factor dict
holds its ``levels`` in host memory: numpy arrays in the reference
package, a ``gridmf.HostLevels`` of CPU tensors here; ``tree_to_torch``
keeps such levels on the CPU (the statistics and the scaling go to the
device) and ``tree_to_numpy`` gives them back as numpy.

A continuation ``Config`` of the reference package becomes this package's
field by field (``nonlin_config_from_reference``), its enums mapped by
name, and either package's ``nonlin.Output`` records read as numpy arrays
(``output_to_numpy``), so that both solvers run one configuration and
their outputs compare step by step.

A ``Tensor2`` or ``Tensor4`` of the reference package becomes this
package's (``tensor2_from``, ``tensor4_from``: the Mandel basis by name,
``vec`` or ``mat`` as numpy onto ``device``), and a distribution of its
``stat`` becomes this package's by its class name and parameters
(``distribution_from``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.nonlin.config import Config as NonlinConfig
from russell_tpu_torch.nonlin.config import Method as NonlinMethod
from russell_tpu_torch.sparse.enums import Genie
from russell_tpu_torch.sparse.kernels import (BsrMatrix, SpgemmPlan, _c_ptr,
                                              bsr_from_arrays)
from russell_tpu_torch.sparse.bcr import lu_perm
from russell_tpu_torch.sparse.genmf import GenMfPlan, _GClass, _GLink
from russell_tpu_torch.sparse.gridmf import HostLevels
from russell_tpu_torch.sparse.splu import SpluPlan
from russell_tpu_torch import stat
from russell_tpu_torch.tensor import Mandel, Tensor2, Tensor4

__all__ = ["splu_plan_from", "splu_plan_fields", "factor_to_torch",
           "factor_to_numpy", "dense_factor_to_torch", "dense_factor_to_numpy",
           "genmf_plan_fields", "genmf_plan_from", "tree_to_torch",
           "tree_to_numpy", "bsr_fields", "bsr_from", "spgemm_plan_from",
           "nonlin_config_from_reference", "output_to_numpy",
           "tensor2_from", "tensor4_from", "distribution_from"]


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
    0-based ``piv`` as tensors on ``device``, ``piv`` 1-based int32, with
    the row order ``perm`` this package's solve reads."""
    out = factor_to_torch({k: v for k, v in fac.items() if k != "piv"},
                          device)
    out["piv"] = torch.as_tensor(
        np.asarray(fac["piv"]).astype(np.int32) + 1, device=out["lu"].device)
    out["perm"] = lu_perm(out["lu"], out["piv"])
    return out


def dense_factor_to_numpy(fac: dict) -> dict:
    """A DENSE factor dict of tensors as numpy arrays on the host, ``piv``
    0-based as in the reference package, without ``perm``."""
    out = factor_to_numpy({k: v for k, v in fac.items() if k != "perm"})
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


def _host_levels(v):
    """Whether ``v`` holds an out-of-core GRIDMF fac's levels: stores
    whose Sinv is a numpy array (the reference package's in-core levels
    are device arrays)."""
    return (isinstance(v, (list, tuple)) and len(v) > 0
            and isinstance(v[-1], dict)
            and isinstance(v[-1].get("sir"), np.ndarray))


def tree_to_torch(obj, device="cuda"):
    """A factor dict of numpy arrays (or anything ``np.asarray`` reads),
    nested in dicts and lists with None leaves, as tensors on ``device``
    in this package's dtypes; ``piv`` / ``pivs`` 1-based int32. The
    ``levels`` of an out-of-core GRIDMF fac (numpy stores) become a
    ``HostLevels`` of CPU tensors."""
    device = russell_tpu_torch.device(device)

    def conv(v, key=None, dev=device):
        if v is None:
            return None
        if isinstance(v, dict):
            out = {k: conv(x, k, dev) for k, x in v.items()}
            if "lus" in out and "pivs" in out:
                out["perms"] = lu_perm(out["lus"], out["pivs"])
            return out
        if key == "levels" and _host_levels(v):
            return HostLevels(conv(x, None, torch.device("cpu")) for x in v)
        if isinstance(v, (list, tuple)):
            return [conv(x, None, dev) for x in v]
        a = np.asarray(v)
        if key in _PIVOTS:
            a = a.astype(np.int32) + 1
        elif key == "n_perturbed":
            a = a.astype(np.int32)
        elif a.dtype.kind == "f":
            a = a.astype(np.float64)
        elif a.dtype.kind == "c":
            a = a.astype(np.complex128)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return conv(obj)


def tree_to_numpy(obj):
    """A nested factor dict of tensors as numpy arrays on the host, with
    ``piv`` / ``pivs`` 0-based as in the reference package and without
    the row orders ``perms``."""
    def conv(v, key=None):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items() if k != "perms"}
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


# Config attributes that are not dataclass fields (class-level defaults)
_NONLIN_EXTRA = ("lin_sol_config", "write_matrix_after_nstep_and_stop")


def nonlin_config_from_reference(jconfig) -> NonlinConfig:
    """This package's ``nonlin.Config`` with every field of ``jconfig`` (a
    ``russell_tpu.nonlin.Config``): ``method`` and ``genie`` mapped by
    name, the tolerances and switches copied."""
    kw = {}
    for f in dataclasses.fields(NonlinConfig):
        v = getattr(jconfig, f.name)
        if f.name == "method":
            v = NonlinMethod[v.name]
        elif f.name == "genie":
            v = Genie[v.name]
        kw[f.name] = v
    config = NonlinConfig(**kw)
    for name in _NONLIN_EXTRA:
        if name in vars(jconfig):
            setattr(config, name, getattr(jconfig, name))
    return config


def output_to_numpy(out) -> dict:
    """The records of a ``nonlin.Output`` (either package's): ``step_h`` and
    ``step_l`` as arrays, and ``step_u`` a dict {component: array}."""
    return {"step_h": np.asarray(out.step_h, dtype=np.float64),
            "step_l": np.asarray(out.step_l, dtype=np.float64),
            "step_u": {m: np.asarray(out.step_u(m), dtype=np.float64)
                       for m in sorted(out._step_u)}}


def tensor2_from(t, device="cuda") -> Tensor2:
    """This package's ``Tensor2`` of either package's ``t``: its Mandel
    basis by name, its ``vec`` as numpy onto ``device``."""
    return Tensor2(Mandel[t.mandel.name], _host(t.vec), device)


def tensor4_from(t, device="cuda") -> Tensor4:
    """This package's ``Tensor4`` of either package's ``t``: its Mandel
    basis by name, its ``mat`` as numpy onto ``device``."""
    return Tensor4(Mandel[t.mandel.name], _host(t.mat), device)


# each distribution's constructor arguments, as its attributes name them
_DISTRIBUTION_PARAMS = {
    "DistributionFrechet": ("location", "scale", "shape"),
    "DistributionGumbel": ("location", "scale"),
    "DistributionLognormal": ("mu", "sig"),
    "DistributionNormal": ("mu", "sig"),
    "DistributionUniform": ("xmin", "xmax"),
}


def distribution_from(d) -> stat.ProbabilityDistribution:
    """This package's distribution of either package's ``d``: the class of
    the same name, built from ``d``'s parameters (host floats)."""
    name = type(d).__name__
    return getattr(stat, name)(*(float(getattr(d, a))
                                 for a in _DISTRIBUTION_PARAMS[name]))
