"""Native direct factorization: the DENSE, SPLU and GRIDMF paths, in
PyTorch.

Counterpart of ``russell_tpu.sparse.factor`` (reference role: the
symbolic analysis + numeric LU + solves of russell_sparse's MUMPS /
UMFPACK / cuDSS backends). The split is the same:

- **analysis** (host, numpy): compute the ordering and freeze every index
  set the numeric phase needs (MUMPS JOB_ANALYZE).
- **numeric factorize / solve** (device): max-norm equilibration, then
  the dense LU with partial pivoting (``torch.linalg.lu_factor_ex`` /
  ``lu_solve``), the SPLU block factorization and packed substitution, or
  the GRIDMF multifrontal factorization and its sweeps, and fixed-count
  iterative refinement against the scaled matrix.

``Genie.DENSE``, ``Genie.SPLU`` and ``Genie.GRIDMF`` are ported. The DENSE
route also factorizes and solves a batch of matrices of one pattern (entry
values (B, nnz), right-hand sides (B, n)), which ``solve_batch`` uses;
``prepare`` uploads every index array of a plan before a CUDA graph
capture, which may not copy from the host.
``Genie.AUTO`` routes as the reference does: n <= ``dense_threshold`` to
DENSE (with or without a ``grid`` hint), a grid hint with a cell-local
pattern above it to GRIDMF. Every other AUTO case (the reference's
BANDED and GENMF routes), and GENMF and BANDED themselves, raise
``NotImplementedError`` rather than route anywhere else. Factors are full
f64/complex128: the H100 has f64, so the reference package's
mixed-precision regime is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from russell_tpu_torch.sparse.enums import Genie, Ordering, Scaling
from russell_tpu_torch.sparse import gridmf as _gridmf
from russell_tpu_torch.sparse import splu as _splu

__all__ = ["SolvePlan", "analyze", "prepare", "numeric_factorize",
           "numeric_factorize_pair", "factor_solve", "factor_solve_pair"]

# Device memory (GiB) that the three f64 value planes of GRIDMF factors of
# Radau5's real and complex pair may take; it picks the leaf, the
# reference's candidates (64, then 16 cells) tried in turn. The factorize
# pair's peak is several times its factors: the complex pivot blocks are
# inverted as their K embedding, at twice the width, with the Schur
# recursion's temporaries (on an H100, npoint-513 Brusselator, leaf 64:
# 10.9 GiB of factors, a 53.6 GiB peak). 15 GiB keeps that ratio's peak
# within the card's 80 GB.
GRIDMF_BUDGET_GB = 15.0
GRIDMF_LEAVES = (64, 16)


@dataclass
class SolvePlan:
    """Static description of a factorization (symbolic phase output)."""

    genie: Genie
    n: int
    # full-pattern entry layout (after symmetric-storage expansion)
    rows: np.ndarray
    cols: np.ndarray
    splu_plan: Optional["_splu.SpluPlan"] = None
    gridmf_plan: Optional["_gridmf.GridMfPlan"] = None
    # DENSE: the entries' dense slots (row-major), one pass per duplicate
    # rank, so that duplicates are summed in entry order on every device
    dense_passes: Optional[list] = None
    scaling: Scaling = Scaling.MAX
    pivot_epsilon: float = 1e-14
    refine_steps: int = 2
    effective_ordering: str = "natural"


def analyze(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    genie: Genie = Genie.AUTO,
    ordering: Ordering = Ordering.AUTO,
    scaling: Scaling = Scaling.AUTO,
    pivot_epsilon: float = 1e-14,
    refine_steps: int = 2,
    dense_threshold: int = 1200,
    mixed_precision: Optional[bool] = None,
    grid: Optional[tuple] = None,
) -> SolvePlan:
    """Symbolic phase: choose a path and freeze the numeric phase's
    indices.

    ``rows``/``cols`` must describe the FULL pattern (triangular symmetric
    storage expanded by the caller). ``grid = (*dims, s)`` — 2-D ``(nr,
    nc, s)`` or 3-D ``(n0, n1, n2, s)`` — is a structure hint (species-major
    layout var = k*prod(dims) + row_major_cell) that unlocks the GRIDMF
    path for cell-local stencil patterns: ``Genie.GRIDMF``, or
    ``Genie.AUTO`` with n > ``dense_threshold``; AUTO takes DENSE at n <=
    ``dense_threshold``. ``mixed_precision=True`` (f32 factors) is not
    ported."""
    if mixed_precision:
        raise NotImplementedError("mixed-precision factors are not ported: "
                                  "the port factorizes in f64 (ROADMAP.md)")
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if grid is not None and (genie == Genie.GRIDMF or
                             (genie == Genie.AUTO and n > dense_threshold)):
        try:
            gplan = _gridmf_plan(n, rows, cols, grid, pivot_epsilon)
        except ValueError:
            if genie == Genie.GRIDMF:
                raise
            gplan = None  # not cell-local: fall through to the AUTO branch
        if gplan is not None:
            return SolvePlan(Genie.GRIDMF, n, rows, cols, gridmf_plan=gplan,
                             scaling=Scaling.MAX if scaling == Scaling.AUTO
                             else scaling,
                             pivot_epsilon=pivot_epsilon,
                             refine_steps=max(refine_steps, 2),
                             effective_ordering="nd-grid")
    if genie == Genie.GRIDMF:
        raise ValueError("Genie.GRIDMF needs a grid=(nr, nc, s) hint "
                         f"covering n={n}")
    if genie == Genie.AUTO and n <= dense_threshold:
        genie = Genie.DENSE
    if genie == Genie.DENSE:
        return SolvePlan(Genie.DENSE, n, rows, cols,
                         dense_passes=_dense_passes(n, rows, cols),
                         scaling=Scaling.NO if scaling == Scaling.AUTO
                         else scaling,
                         pivot_epsilon=pivot_epsilon, refine_steps=0,
                         effective_ordering="natural")
    if genie != Genie.SPLU:
        raise NotImplementedError(
            f"genie {genie} is not ported yet for this system (n={n}, "
            f"grid={grid}): the port has Genie.DENSE (AUTO takes it at n "
            "<= dense_threshold), Genie.SPLU, and Genie.GRIDMF for "
            "grid-hinted cell-local systems (AUTO takes it above "
            "dense_threshold); BANDED and GENMF, AUTO's other routes, are "
            "later slices (ROADMAP.md queue 1, items 9 and 11)")
    # METIS is nested dissection in the reference (enums.rs:71-158);
    # "nd" plays the same role AND unlocks the level-batched numeric
    # phase. AUTO tries both symbolics (cheap, host-only) and keeps the
    # one with fewer stored blocks. Block size 32, as in the reference
    # package, so both build the same plan.
    bsz = 32
    if ordering == Ordering.AUTO:
        plan_nd = _splu.splu_analyze(n, rows, cols, ordering="nd",
                                     block_size=bsz,
                                     pivot_epsilon=pivot_epsilon)
        if n > 20_000:
            # mindeg's clique formation is superlinear; at this size
            # nested dissection wins anyway (grid-like problems)
            plan, eff_ord = plan_nd, "nd"
        else:
            plan_amd = _splu.splu_analyze(n, rows, cols, ordering="amd",
                                          block_size=bsz,
                                          pivot_epsilon=pivot_epsilon)
            if plan_nd.nblk <= plan_amd.nblk:
                plan, eff_ord = plan_nd, "nd"
            else:
                plan, eff_ord = plan_amd, "amd"
    else:
        eff_ord = {Ordering.METIS: "nd", Ordering.AMD: "amd"}.get(
            ordering, "natural")
        plan = _splu.splu_analyze(n, rows, cols, ordering=eff_ord,
                                  block_size=bsz,
                                  pivot_epsilon=pivot_epsilon)
    return SolvePlan(Genie.SPLU, n, rows, cols, splu_plan=plan,
                     scaling=Scaling.MAX if scaling == Scaling.AUTO
                     else scaling,
                     pivot_epsilon=pivot_epsilon,
                     refine_steps=max(refine_steps, 2),
                     effective_ordering=eff_ord)


def _dense_passes(n, rows, cols):
    """[(entry ids, dense slots)] per duplicate rank: pass k holds the k-th
    entry (in entry order) of every slot that has more than k entries, so
    each pass writes distinct slots and the passes add a slot's entries
    left to right, as a sequential scatter-add does."""
    slot = rows * n + cols
    order = np.argsort(slot, kind="stable")
    s_sorted = slot[order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    rank = np.arange(len(slot)) - np.repeat(starts, np.diff(
        np.r_[starts, len(slot)]))
    passes = []
    for k in range(int(rank.max()) + 1 if len(slot) else 0):
        ids = order[rank == k]
        passes.append((ids, slot[ids]))
    return passes


def _gridmf_plan(n, rows, cols, grid, pivot_epsilon):
    """The GRIDMF plan at the first leaf size of GRIDMF_LEAVES whose three
    f64 value planes of factors fit GRIDMF_BUDGET_GB (the last one when
    none does but its real plane fits). Raises ValueError for a pattern
    that is not cell-local, and NotImplementedError when even the real
    plane of the smallest leaf's factors exceeds the budget: the
    reference streams those factors to host memory, which is a later
    slice (ROADMAP.md queue 1, item 12)."""
    for leaf in GRIDMF_LEAVES:
        gplan = _gridmf.gridmf_analyze(n, rows, cols, grid,
                                       leaf_cells=leaf,
                                       pivot_epsilon=pivot_epsilon)
        store_gb = _gridmf.gridmf_store_gb(gplan)
        if 3.0 * store_gb <= GRIDMF_BUDGET_GB:
            return gplan
    if store_gb > GRIDMF_BUDGET_GB:
        raise NotImplementedError(
            f"GRIDMF factors of {store_gb:.1f} GiB a value plane exceed the "
            f"{GRIDMF_BUDGET_GB} GiB device budget; the out-of-core path "
            "that streams them to host memory is not ported yet "
            "(ROADMAP.md queue 1, item 12)")
    return gplan


def _on_device(plan: SolvePlan, what: str, device, make):
    """``make(device)`` for the plan's host arrays ``what``, uploaded once
    per (plan, device)."""
    cache = plan.__dict__.setdefault("_device_cache", {})
    key = (what, str(torch.device(device)))
    ent = cache.get(key)
    if ent is None:
        ent = cache[key] = make(device)
    return ent


def _device_indices(plan: SolvePlan, device):
    """(rows, cols) on ``device``, uploaded once per (plan, device)."""
    return _on_device(plan, "rows_cols", device, lambda d: (
        torch.as_tensor(plan.rows, device=d),
        torch.as_tensor(plan.cols, device=d)))


def prepare(plan: SolvePlan, device, stream=None):
    """Upload every array the plan's numeric phase reads to ``device``
    (each is uploaded once per (plan, device) anyway), and for SPLU the
    pair kernel's ticket buffer of the CUDA ``stream`` that will run the
    factorization: afterwards a factorize or solve copies nothing from
    the host, so it can be captured into a CUDA graph."""
    device = torch.device(device)
    _device_indices(plan, device)
    if plan.genie == Genie.DENSE:
        _dense_passes_on(plan, device)
    elif plan.genie == Genie.GRIDMF:
        _gridmf._device_plan(plan.gridmf_plan, device)
    elif plan.genie == Genie.SPLU:
        _splu._device_plan(plan.splu_plan, device)
        if stream is not None and device.type == "cuda":
            _splu.prepare_stream(plan.splu_plan, device, stream)


def _segment_max(vals, seg, n):
    """Per-segment max of ``vals`` along its last dimension (segments with
    no entry give 0, which the callers treat like the reference's -inf: no
    scaling)."""
    out = torch.zeros(vals.shape[:-1] + (n,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_reduce_(-1, seg.expand(vals.shape), vals, "amax",
                               include_self=False)


def _segment_sum(vals, seg, n):
    out = torch.zeros(vals.shape[:-1] + (n,), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(-1, seg, vals)


def _equilibrate(plan: SolvePlan, data):
    """Max-norm row/col scaling computed on the device; returns
    (data', rs, cs). A leading batch dimension of ``data`` gives one
    scaling per matrix."""
    n = plan.n
    rows, cols = _device_indices(plan, data.device)
    rdt = data.real.dtype if data.is_complex() else data.dtype
    if plan.scaling == Scaling.NO:
        rs = torch.ones(data.shape[:-1] + (n,), dtype=rdt,
                        device=data.device)
        return data, rs, rs
    absd = data.abs()
    rmax = _segment_max(absd, rows, n)
    rs = torch.where(rmax > 0, 1.0 / rmax, 1.0)
    absd2 = absd * rs[..., rows]
    cmax = _segment_max(absd2, cols, n)
    cs = torch.where(cmax > 0, 1.0 / cmax, 1.0)
    if plan.scaling == Scaling.ROW_COL_ITER:
        for _ in range(2):
            absd3 = absd * rs[..., rows] * cs[..., cols]
            rmax = _segment_max(absd3, rows, n)
            rs = rs * torch.where(rmax > 0, 1.0 / torch.sqrt(rmax), 1.0)
            absd3 = absd * rs[..., rows] * cs[..., cols]
            cmax = _segment_max(absd3, cols, n)
            cs = cs * torch.where(cmax > 0, 1.0 / cmax, 1.0)
    return data * (rs[..., rows] * cs[..., cols]).to(data.dtype), rs, cs


def _logdet_update(diag, piv):
    """(log|det|, phase) of LU factors' U diagonals and their pivots, one
    per matrix of a batch (``torch.linalg`` pivots are 1-based, where the
    reference package's are 0-based)."""
    k = diag.shape[-1]
    swaps = torch.sum(piv != torch.arange(1, k + 1, dtype=piv.dtype,
                                          device=piv.device), dim=-1)
    absd = diag.abs()
    sign = (1 - 2 * (swaps % 2)).to(absd.dtype)
    safe = torch.where(absd > 0, absd, 1.0)
    logdet = torch.sum(torch.where(absd > 0, torch.log(safe), -torch.inf),
                       dim=-1)
    if diag.is_complex():
        phase = torch.prod(torch.where(absd > 0, diag / safe.to(diag.dtype),
                                       0.0), dim=-1) * sign
    else:
        phase = torch.prod(torch.sign(diag), dim=-1) * sign
    return logdet, phase


def _dense_passes_on(plan: SolvePlan, device):
    return _on_device(plan, "dense_passes", device, lambda d: [
        (torch.as_tensor(ids, device=d), torch.as_tensor(slots, device=d))
        for ids, slots in plan.dense_passes])


def _dense_factorize(plan: SolvePlan, data):
    """LU of the entries ``data`` (nnz,), or of a batch (B, nnz) of them."""
    n = plan.n
    data, rs, cs = _equilibrate(plan, data)
    batch = data.shape[:-1]
    a = torch.zeros(batch + (n * n,), dtype=data.dtype, device=data.device)
    for ids, slots in _dense_passes_on(plan, data.device):
        a[..., slots] = a[..., slots] + data[..., ids]
    lu, piv, _ = torch.linalg.lu_factor_ex(a.reshape(batch + (n, n)))
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    logdet, phase = _logdet_update(diag, piv)
    return {"lu": lu, "piv": piv, "rs": rs, "cs": cs, "logdet": logdet,
            "phase": phase, "min_pivot": diag.abs().amin(dim=-1),
            "data": data}  # scaled entries (kept for refinement)


def _dense_solve(plan: SolvePlan, fac, b):
    out_dtype = fac["data"].dtype
    y = fac["rs"].to(out_dtype) * b.to(out_dtype)
    x = torch.linalg.lu_solve(fac["lu"], fac["piv"], y[..., None])[..., 0]
    return fac["cs"].to(out_dtype) * x


def _check_plan(plan: SolvePlan, values=None):
    if plan.genie not in (Genie.DENSE, Genie.SPLU, Genie.GRIDMF):
        raise NotImplementedError(f"genie {plan.genie} is not ported yet "
                                  "(ROADMAP.md)")
    if values is not None and values.dim() > 1 and plan.genie != Genie.DENSE:
        raise NotImplementedError(
            f"a batch of matrices factorizes through Genie.DENSE only; a "
            f"batched numeric phase of {plan.genie.name} over one plan is "
            "not ported yet (ROADMAP.md queue 1, item 17)")


def numeric_factorize(plan: SolvePlan, data):
    """Numeric factorization of the entry values ``data`` (f64 or
    complex128 tensor, on the device to factorize on) laid out as
    (plan.rows, plan.cols); DENSE also takes a batch (B, nnz)."""
    _check_plan(plan, data)
    if plan.genie == Genie.DENSE:
        return _dense_factorize(plan, data)
    data, rs, cs = _equilibrate(plan, data)
    if plan.genie == Genie.GRIDMF:
        fac = _gridmf.gridmf_factorize(plan.gridmf_plan, data)
    else:
        fac = _splu.splu_factorize(plan.splu_plan, data)
    fac["rs"] = rs
    fac["cs"] = cs
    fac["data"] = data  # scaled entries (kept for refinement)
    return fac


def numeric_factorize_pair(plan: SolvePlan, data_r, data_c):
    """Factorize TWO matrices with the same structure (Radau5's real and
    complex Newton matrices). For SPLU both run in ONE pass over the
    packed schedule (splu_factorize_multi) — the analog of the reference's
    concurrent real/complex factorization (radau5.rs, P5); DENSE and GRIDMF
    factor them one after the other, as the reference package does."""
    _check_plan(plan, data_r)
    if plan.genie != Genie.SPLU:
        return (numeric_factorize(plan, data_r),
                numeric_factorize(plan, data_c))
    dr, rs_r, cs_r = _equilibrate(plan, data_r)
    dc, rs_c, cs_c = _equilibrate(plan, data_c)
    fr, fc = _splu.splu_factorize_multi(plan.splu_plan, (dr, dc))
    fr["rs"], fr["cs"], fr["data"] = rs_r, cs_r, dr
    fc["rs"], fc["cs"], fc["data"] = rs_c, cs_c, dc
    return fr, fc


def _residual(plan: SolvePlan, fac, x, b):
    """Unscaled-rhs-space residual b - A x through the scaled entries:
    R(b - A x) = R b - As (C^{-1} x), then divided by R."""
    rows, cols = _device_indices(plan, x.device)
    dtype = x.dtype
    u = x / fac["cs"].to(dtype)
    ax = _segment_sum(fac["data"] * u[..., cols], rows, plan.n)
    return (fac["rs"].to(dtype) * b.to(dtype) - ax) / fac["rs"].to(dtype)


def _solve_once(plan: SolvePlan, fac, b):
    if plan.genie == Genie.DENSE:
        return _dense_solve(plan, fac, b)
    out_dtype = fac["data"].dtype
    y = fac["rs"].to(out_dtype) * b.to(out_dtype)
    if plan.genie == Genie.GRIDMF:
        x = _gridmf.gridmf_solve(plan.gridmf_plan, fac, y)
    else:
        x = _splu.splu_solve(plan.splu_plan, fac, y)
    return fac["cs"].to(out_dtype) * x.to(out_dtype)


def factor_solve(plan: SolvePlan, fac, b, refine_steps=None):
    """Solve A x = b from a numeric factorization, with ``refine_steps``
    (default ``plan.refine_steps``) rounds of iterative refinement
    against the scaled matrix. Radau5 passes 0 for its Newton solves.
    DENSE factors of a batch take right-hand sides (B, n)."""
    _check_plan(plan, b)
    if refine_steps is None:
        refine_steps = plan.refine_steps
    x = _solve_once(plan, fac, b)
    for _ in range(refine_steps):
        x = x + _solve_once(plan, fac, _residual(plan, fac, x, b))
    return x


def factor_solve_pair(plan: SolvePlan, fac_r, fac_c, b_r, b_c,
                      refine_steps=None):
    """Solve the real and complex systems TOGETHER (for SPLU one
    packed-substitution pass per refinement round covers both; DENSE and
    GRIDMF solve them one after the other, as the reference package
    does)."""
    _check_plan(plan, b_r)
    if refine_steps is None:
        refine_steps = plan.refine_steps
    if plan.genie != Genie.SPLU:
        return (factor_solve(plan, fac_r, b_r, refine_steps),
                factor_solve(plan, fac_c, b_c, refine_steps))
    facs = (fac_r, fac_c)
    bs = (b_r, b_c)

    def solve_once_pair(rhs):
        ys = [f["rs"].to(f["data"].dtype) * v.to(f["data"].dtype)
              for f, v in zip(facs, rhs)]
        xs = _splu.splu_solve_multi(plan.splu_plan, facs, ys)
        return [f["cs"].to(f["data"].dtype) * x.to(f["data"].dtype)
                for f, x in zip(facs, xs)]

    xs = solve_once_pair(bs)
    for _ in range(refine_steps):
        resids = [_residual(plan, f, x, v) for f, x, v in zip(facs, xs, bs)]
        dxs = solve_once_pair(resids)
        xs = [x + dx for x, dx in zip(xs, dxs)]
    return xs[0], xs[1]
