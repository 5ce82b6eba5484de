"""Native direct factorization: the DENSE, BANDED, SPLU, GRIDMF and GENMF
paths, in PyTorch.

Counterpart of ``russell_tpu.sparse.factor`` (reference role: the
symbolic analysis + numeric LU + solves of russell_sparse's MUMPS /
UMFPACK / cuDSS backends). The split is the same:

- **analysis** (host, numpy): pick a path, compute the ordering and
  freeze every index set the numeric phase needs (MUMPS JOB_ANALYZE).
- **numeric factorize / solve** (device): max-norm equilibration, then
  the dense LU with partial pivoting (``bcr.lu_factor``, the pivots'
  row order made once; a solve is a gather and two triangular solves,
  ``bcr.lu_solve``), the block-tridiagonal BANDED elimination (a sequential
  scan or block cyclic reduction, ``bcr``), the SPLU block factorization
  and packed substitution, or the GRIDMF / GENMF multifrontal
  factorizations and their sweeps, and fixed-count iterative refinement
  against the scaled matrix.

``Genie.AUTO`` routes as the reference does: n <= ``dense_threshold`` to
DENSE (with or without a ``grid`` hint), a grid hint with a cell-local
pattern above it to GRIDMF, else BANDED when the RCM bandwidth is at most
``max_block`` and GENMF otherwise. Every route also factorizes and solves
a batch of matrices of one pattern over the one plan (entry values (B,
nnz), right-hand sides (B, n), one lane each), which ``solve_batch`` and
``parallel.batch_factor_solve`` use: the numeric phase runs once over a
leading lane dimension, not once a matrix. ``prepare`` uploads every
index array of a plan before a CUDA graph capture, which may not copy
from the host.

Factors are f64/complex128 unless ``analyze(mixed_precision=True)``: the
reference package's mixed-precision regime (LAPACK's dsgesv, cuDSS's
mixed mode) then factorizes in f32/complex64 through every genie, keeps
the scaled entries at the input precision and refines against them with
the reference's adaptive tiers (``factor_solve``): plain iterative
refinement while it contracts, flexible CG for numerically symmetric real
systems (``SolvePlan.symmetric_values``), then FGMRES(10) cycles
preconditioned by the f32 factors. ``None`` is f64 here: the reference's
default is "mixed on a TPU backend", and the card has f64. A complex128
system's refinement runs in complex128 against complex128 scaled entries
(the reference instead keeps c64 entries and refines f64 real planes,
``factor_solve_planes``, because its TPU has no complex128); its solution
is held to the same 1e-12 relative error.

GRIDMF factors too large for the device budget (``GRIDMF_BUDGET_GB``) go
out of core, as in the reference package: ``analyze`` marks the plan
(``gridmf_ooc``), ``numeric_factorize`` streams one matrix's factors to
host memory (``gridmf.gridmf_factorize_ooc``) and ``factor_solve`` ships
them back level by level (``gridmf.gridmf_solve_ooc``). Where the
reference package factorizes under ``jit`` or ``vmap`` (Radau5's and the
fused loops' pairs, BwEuler, batches), its data is traced and the plan
runs in core; the port does the same on those paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from russell_tpu_torch.sparse.enums import Genie, Ordering, Scaling
from russell_tpu_torch.sparse.ordering import (bandwidth, rank_passes,
                                               rcm_ordering, segment_index)
from russell_tpu_torch.sparse import bcr as _bcr
from russell_tpu_torch.sparse import genmf as _genmf
from russell_tpu_torch.sparse import gridmf as _gridmf
from russell_tpu_torch.sparse import splu as _splu

__all__ = ["SolvePlan", "analyze", "prepare", "numeric_factorize",
           "numeric_factorize_pair", "factor_solve", "factor_solve_batch",
           "factor_solve_pair",
           "det_phase"]

# Device memory (GiB) that the three f64 value planes of GRIDMF factors of
# Radau5's real and complex pair may take; it picks the leaf, the
# reference's candidates (64, then 16 cells) tried in turn, and sends the
# factors out of core when even the last leaf's real plane exceeds it. The
# factorize pair's peak is several times its factors: the complex pivot
# blocks are inverted as their K embedding, at twice the width, with the
# Schur recursion's temporaries (on an H100, npoint-513 Brusselator, leaf
# 64: 10.9 GiB of factors, a 53.6 GiB peak). 15 GiB keeps that ratio's
# peak within the card's 80 GB.
GRIDMF_BUDGET_GB = 15.0
GRIDMF_LEAVES = (64, 16)
# the adaptive refinement of mixed-precision factors: the reference
# package's constants (factor.py:1225-1250, 1350)
IR_MAX_STEPS = 20       # plain refinement rounds at most
FGMRES_M = 10           # Krylov dimension of an FGMRES cycle
FGMRES_CYCLES = 6       # FGMRES cycles at most
CG_MAX = 40             # flexible CG iterations at most
# GENMF's leaf size: the reference package's default (factor.py:238-242,
# chosen there by a sweep on geometric_264k)
GENMF_LEAF = 256


@dataclass
class SolvePlan:
    """Static description of a factorization (symbolic phase output)."""

    genie: Genie
    n: int
    # full-pattern entry layout (after symmetric-storage expansion)
    rows: np.ndarray
    cols: np.ndarray
    # BANDED: symmetric permutation, block size, number of blocks, the
    # entries' slots in the (3, nb, k, k) band blocks, the padding rows'
    # unit diagonal slots, and the kernel (cyclic reduction or the scan)
    perm: Optional[np.ndarray] = None
    block_k: int = 0
    nb: int = 0
    flat_idx: Optional[np.ndarray] = None
    pad_idx: Optional[np.ndarray] = None
    use_bcr: bool = False
    splu_plan: Optional["_splu.SpluPlan"] = None
    gridmf_plan: Optional["_gridmf.GridMfPlan"] = None
    # the GRIDMF factors exceed GRIDMF_BUDGET_GB: one matrix's go to host
    # memory depth by depth (gridmf.gridmf_factorize_ooc)
    gridmf_ooc: bool = False
    genmf_plan: Optional["_genmf.GenMfPlan"] = None
    # DENSE: the entries' dense slots (row-major), one pass per duplicate
    # rank, so that duplicates are summed in entry order on every device
    dense_passes: Optional[list] = None
    scaling: Scaling = Scaling.MAX
    pivot_epsilon: float = 1e-14
    refine_steps: int = 2
    effective_ordering: str = "natural"
    # mixed precision: the factors in f32/complex64, the residuals of the
    # refinement at the input precision
    mixed32: bool = False
    # the assembled values are numerically symmetric (set by
    # LinSolver.factorize under mixed precision): unlocks the flexible-CG
    # refinement tier
    symmetric_values: bool = False

    @property
    def n_pad(self) -> int:
        return self.nb * self.block_k if self.genie == Genie.BANDED else self.n


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
    max_block: int = 4096,
    mixed_precision: Optional[bool] = None,
    banded_kernel: str = "auto",
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
    ``dense_threshold``, and above it without a usable hint BANDED when the
    RCM bandwidth is at most ``max_block``, else GENMF. ``banded_kernel``
    ("auto", "bcr" or "scan") picks BANDED's kernel; "auto" takes cyclic
    reduction at nb >= 32 blocks. ``mixed_precision=True`` factorizes in
    f32/complex64 (``SolvePlan.mixed32``; at least 3 refinement rounds, 2
    for DENSE), and GRIDMF's budget then charges 4 bytes a value; None or
    False factorizes at the input precision."""
    mixed = bool(mixed_precision)
    if mixed:
        refine_steps = max(refine_steps, 3)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if grid is not None and (genie == Genie.GRIDMF or
                             (genie == Genie.AUTO and n > dense_threshold)):
        try:
            gplan, ooc = _gridmf_plan(n, rows, cols, grid, pivot_epsilon,
                                      4 if mixed else 8)
        except ValueError:
            if genie == Genie.GRIDMF:
                raise
            gplan = None  # not cell-local: fall through to the AUTO branch
        if gplan is not None:
            return SolvePlan(Genie.GRIDMF, n, rows, cols, gridmf_plan=gplan,
                             gridmf_ooc=ooc,
                             scaling=Scaling.MAX if scaling == Scaling.AUTO
                             else scaling,
                             pivot_epsilon=pivot_epsilon,
                             refine_steps=max(refine_steps, 2),
                             effective_ordering="nd-grid", mixed32=mixed)
    if genie == Genie.GRIDMF:
        raise ValueError("Genie.GRIDMF needs a grid=(nr, nc, s) hint "
                         f"covering n={n}")
    if genie == Genie.AUTO:
        if n <= dense_threshold:
            genie = Genie.DENSE
        else:
            # BANDED when the RCM bandwidth is small; else the general
            # multifrontal (GENMF)
            perm_try = rcm_ordering(n, rows, cols)
            bw_try = min(bandwidth(rows, cols), bandwidth(rows, cols,
                                                          perm_try))
            genie = Genie.BANDED if bw_try <= max_block else Genie.GENMF
    if genie == Genie.GENMF:
        gplan = _genmf.genmf_analyze(n, rows, cols, leaf_target=GENMF_LEAF,
                                     pivot_epsilon=pivot_epsilon)
        return SolvePlan(Genie.GENMF, n, rows, cols, genmf_plan=gplan,
                         scaling=Scaling.MAX if scaling == Scaling.AUTO
                         else scaling,
                         pivot_epsilon=pivot_epsilon,
                         refine_steps=max(refine_steps, 2),
                         effective_ordering="nd-general", mixed32=mixed)
    if genie == Genie.DENSE:
        return _dense_plan(n, rows, cols, scaling, pivot_epsilon, mixed)
    if genie == Genie.BANDED:
        return _banded_plan(n, rows, cols, ordering, scaling, pivot_epsilon,
                            refine_steps, max_block, banded_kernel, mixed)
    if genie != Genie.SPLU:
        raise ValueError(f"genie {genie} is not available in analyze()")
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
                     effective_ordering=eff_ord, mixed32=mixed)


def _dense_plan(n, rows, cols, scaling, pivot_epsilon, mixed):
    return SolvePlan(Genie.DENSE, n, rows, cols,
                     dense_passes=_dense_passes(n, rows, cols),
                     scaling=Scaling.NO if scaling == Scaling.AUTO
                     else scaling,
                     pivot_epsilon=pivot_epsilon,
                     refine_steps=2 if mixed else 0,
                     effective_ordering="natural", mixed32=mixed)


def _banded_plan(n, rows, cols, ordering, scaling, pivot_epsilon,
                 refine_steps, max_block, banded_kernel, mixed):
    """RCM-reorder (when it narrows the band), view the band as a
    block-tridiagonal matrix with block size k >= bandwidth (a multiple of
    8, as the reference package picks it), and freeze each entry's slot in
    the (3, nb, k, k) band blocks: 0 = sub (E), 1 = diagonal (D), 2 =
    super (F). nb < 2 blocks is DENSE."""
    if ordering in (Ordering.AUTO, Ordering.RCM, Ordering.AMD,
                    Ordering.METIS):
        natural_bw = bandwidth(rows, cols)
        perm = rcm_ordering(n, rows, cols)
        rcm_bw = bandwidth(rows, cols, perm)
        if rcm_bw < natural_bw:
            eff = "rcm"
        else:
            perm = np.arange(n, dtype=np.int64)
            rcm_bw = natural_bw
            eff = "natural"
    else:
        perm = np.arange(n, dtype=np.int64)
        rcm_bw = bandwidth(rows, cols)
        eff = "natural"
    bw = max(int(rcm_bw), 1)
    if bw > max_block:
        raise ValueError(
            f"bandwidth {bw} exceeds max_block {max_block}; "
            "use Genie.DENSE or Genie.SPLU")
    k = -(-bw // 8) * 8
    k = min(k, max(8, -(-n // 8) * 8))
    nb = -(-n // k)
    if nb < 2:
        # degenerate band: dense is simpler and exact-pivoting
        return _dense_plan(n, rows, cols, Scaling.NO, pivot_epsilon, mixed)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    r = iperm[rows]
    c = iperm[cols]
    bi = r // k
    bj = c // k
    if np.max(np.abs(bi - bj)) > 1:
        raise AssertionError("block partition violates tridiagonal structure")
    band = (bj - bi + 1).astype(np.int64)
    li = r - bi * k
    lj = c - bj * k
    flat_idx = ((band * nb + bi) * k + li) * k + lj
    # padding rows get unit diagonal in D
    pad = np.arange(n, nb * k, dtype=np.int64)
    lp = pad - (pad // k) * k
    pad_idx = ((1 * nb + pad // k) * k + lp) * k + lp
    if banded_kernel == "auto":
        use_bcr = nb >= 32  # log-depth wins over the sequential scan
    else:
        use_bcr = banded_kernel == "bcr"
    return SolvePlan(Genie.BANDED, n, rows, cols, perm=perm, block_k=k,
                     nb=nb, flat_idx=flat_idx.astype(np.int32),
                     pad_idx=pad_idx.astype(np.int32), use_bcr=use_bcr,
                     scaling=Scaling.MAX if scaling == Scaling.AUTO
                     else scaling,
                     pivot_epsilon=pivot_epsilon, refine_steps=refine_steps,
                     effective_ordering=eff, mixed32=mixed)


def _dense_passes(n, rows, cols):
    """[(entry ids, dense slots)] per duplicate rank (``rank_passes``), so
    that duplicates are summed in entry order on every device."""
    slot = rows * n + cols
    return [(ids, slot[ids]) for ids in rank_passes(slot)]


def _gridmf_plan(n, rows, cols, grid, pivot_epsilon, bytes_per=8):
    """(plan, out of core?): the GRIDMF plan at the first leaf size of
    GRIDMF_LEAVES whose three value planes of factors (``bytes_per`` a
    value: 8, or 4 for mixed-precision factors) fit GRIDMF_BUDGET_GB,
    else at the last one, out of core when even its real plane exceeds
    the budget (the reference package's rule). Raises ValueError for a
    pattern that is not cell-local."""
    for leaf in GRIDMF_LEAVES:
        gplan = _gridmf.gridmf_analyze(n, rows, cols, grid,
                                       leaf_cells=leaf,
                                       pivot_epsilon=pivot_epsilon)
        store_gb = _gridmf.gridmf_store_gb(gplan, bytes_per)
        if 3.0 * store_gb <= GRIDMF_BUDGET_GB:
            return gplan, False
    return gplan, store_gb > GRIDMF_BUDGET_GB


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


def prepare(plan: SolvePlan, device, stream=None, lanes: int = 1):
    """Upload every array the plan's numeric phase reads to ``device``
    (each is uploaded once per (plan, device) anyway), and for SPLU the
    pair kernel's ticket buffer of the CUDA ``stream`` that will run the
    factorization of ``lanes`` matrices at once: afterwards a factorize or
    solve copies nothing from the host, so it can be captured into a CUDA
    graph."""
    device = torch.device(device)
    _device_indices(plan, device)
    _seg_index(plan, "rows", device)
    if plan.genie == Genie.DENSE:
        _dense_passes_on(plan, device)
    elif plan.genie == Genie.GRIDMF:
        _gridmf._device_plan(plan.gridmf_plan, device)
    elif plan.genie == Genie.GENMF:
        _genmf._device_plan(plan.genmf_plan, device)
    elif plan.genie == Genie.BANDED:
        _banded_indices(plan, device)
    elif plan.genie == Genie.SPLU:
        _splu._device_plan(plan.splu_plan, device)
        if stream is not None and device.type == "cuda":
            _splu.prepare_stream(plan.splu_plan, device, stream, lanes)


def _segment_max(vals, seg, n):
    """Per-segment max of ``vals`` along its last dimension (segments with
    no entry give 0, which the callers treat like the reference's -inf: no
    scaling)."""
    out = torch.zeros(vals.shape[:-1] + (n,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_reduce_(-1, seg.expand(vals.shape), vals, "amax",
                               include_self=False)


def _seg_index(plan: SolvePlan, which: str, device):
    """The entries' rows' or cols' (``which``) ``segment_index``, uploaded
    once per (plan, device)."""
    def make(d):
        order, offsets = segment_index(getattr(plan, which), plan.n)
        return (None if order is None else torch.as_tensor(order, device=d),
                torch.as_tensor(offsets, device=d))
    return _on_device(plan, f"{which}_sum", device, make)


def _seg_sum(plan: SolvePlan, vals, which: str):
    """Per-row (or per-col) sum of the entry values ``vals`` (last
    dimension), in entry order (``splu.segment_sum``): the same bits on
    every run."""
    order, offsets = _seg_index(plan, which, vals.device)
    return _splu.segment_sum(vals.movedim(-1, 0), order,
                             offsets).movedim(0, -1)


def _row_sum(plan: SolvePlan, vals):
    return _seg_sum(plan, vals, "rows")


def _col_sum(plan: SolvePlan, vals):
    return _seg_sum(plan, vals, "cols")


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


def _prod(x):
    """The product over the last dimension. A complex one is a tree of
    elementwise products: ``torch.prod`` of complex values on the card
    compiles its reduction kernel at run time (NVRTC) at its first call
    in a process for each layout, ~14 s on an H100's host."""
    if not x.is_complex():
        return x.prod(-1)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] * x[..., 1::2]
    return x[..., 0]


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
        phase = _prod(torch.where(absd > 0, diag / safe.to(diag.dtype),
                                  0.0)) * sign
    else:
        phase = torch.prod(torch.sign(diag), dim=-1) * sign
    return logdet, phase


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_LOW = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def _factor_dtype(plan: SolvePlan, dtype):
    """The factors' dtype for values of ``dtype``: f32/complex64 for
    f64/complex128 under mixed precision (the reference package's
    ``_factor_dtype``), else ``dtype``."""
    return _LOW.get(dtype, dtype) if plan.mixed32 else dtype


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
    lu, piv = _bcr.lu_factor(a.reshape(batch + (n, n)).to(
        _factor_dtype(plan, data.dtype)))
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    logdet, phase = _logdet_update(diag, piv)
    return {"lu": lu, "piv": piv, "perm": _bcr.lu_perm(lu, piv), "rs": rs,
            "cs": cs, "logdet": logdet,
            "phase": phase, "min_pivot": diag.abs().amin(dim=-1),
            "data": data}  # scaled entries (kept for refinement)


def _dense_solve(plan: SolvePlan, fac, b):
    out_dtype = fac["data"].dtype
    y = fac["rs"].to(out_dtype) * b.to(out_dtype)
    x = _bcr.lu_solve(fac["lu"], fac["perm"],
                      y.to(fac["lu"].dtype)[..., None])[..., 0]
    return fac["cs"].to(out_dtype) * x.to(out_dtype)


def _banded_indices(plan: SolvePlan, device):
    """BANDED's index arrays on ``device``: the band-block slots of the
    entries in passes of one duplicate rank, the padding diagonal, and
    the permutation and its inverse."""
    def make(d):
        t = lambda a: torch.as_tensor(a, device=d)
        iperm = np.empty(plan.n, dtype=np.int64)
        iperm[plan.perm] = np.arange(plan.n)
        return {"passes": [(t(ids), t(plan.flat_idx[ids]))
                           for ids in rank_passes(plan.flat_idx)],
                "pad": t(plan.pad_idx), "perm": t(plan.perm),
                "iperm": t(iperm)}
    return _on_device(plan, "banded", device, make)


def _banded_scatter(plan: SolvePlan, data):
    """The (..., 3, nb, k, k) band blocks E, D, F of the scaled entries
    (..., nnz), a unit diagonal in the padding rows; duplicates add in
    entry order."""
    nb, k = plan.nb, plan.block_k
    lead = data.shape[:-1]
    ix = _banded_indices(plan, data.device)
    flat = torch.zeros(lead + (3 * nb * k * k,), dtype=data.dtype,
                       device=data.device)
    flat[..., ix["pad"]] = flat.new_ones(())
    for ids, slots in ix["passes"]:
        flat.index_add_(-1, slots, data.index_select(-1, ids))
    return flat.view(lead + (3, nb, k, k))


def _banded_factorize_bcr(plan: SolvePlan, data, split=None):
    """BANDED through cyclic reduction; ``split`` spreads its levels over
    ranks (``bcr.bcr_factorize``), each split level's log|det| and sign
    then summed over the ranks in rank order. A batch (B, nnz) runs every
    matrix's levels together."""
    data, rs, cs = _equilibrate(plan, data)
    blocks = _banded_scatter(plan, data).to(_factor_dtype(plan, data.dtype))
    fac = _bcr.bcr_factorize(blocks[..., 1, :, :, :], blocks[..., 0, :, :, :],
                             blocks[..., 2, :, :, :],
                             pivot_epsilon=plan.pivot_epsilon, split=split)
    fac["rs"] = rs
    fac["cs"] = cs
    fac["data"] = data
    # det(A) = prod_levels det(odd diagonal blocks) * det(root): cyclic
    # reduction eliminates exact Schur complements, so the products of the
    # level LU diagonals reproduce the full determinant
    ld = ph = None
    for lv in fac["levels"] + [fac["root"]]:
        l, p = _logdet_update(torch.diagonal(lv["lus"], dim1=-2, dim2=-1),
                              lv["pivs"])
        l, p = l.sum(-1), _prod(p)
        if lv.get("range") is not None:
            st = split.combine(logdet=l, phase=p)
            l, p = st["logdet"], st["phase"]
        ld = l if ld is None else ld + l
        ph = p if ph is None else ph * p
    fac["logdet"] = ld
    fac["phase"] = ph
    return fac


def _banded_rhs(plan: SolvePlan, fac, b):
    """The scaled, permuted and padded right-hand sides (..., nb, k)."""
    n, k, nb = plan.n, plan.block_k, plan.nb
    ix = _banded_indices(plan, b.device)
    bs = (fac["rs"] * b.to(fac["data"].dtype))[..., ix["perm"]]
    bp = torch.zeros(b.shape[:-1] + (nb * k,), dtype=bs.dtype,
                     device=b.device)
    bp[..., :n] = bs
    return bp.view(b.shape[:-1] + (nb, k))


def _banded_x(plan: SolvePlan, fac, xp):
    """x, at the values' precision, from the padded, permuted solution
    (..., nb, k)."""
    ix = _banded_indices(plan, xp.device)
    out_dtype = fac["data"].dtype
    x = xp.reshape(xp.shape[:-2] + (-1,))[..., :plan.n]
    return fac["cs"].to(out_dtype) * x[..., ix["iperm"]].to(out_dtype)


def _banded_solve_bcr(plan: SolvePlan, fac, b, split=None):
    return _banded_x(plan, fac, _bcr.bcr_solve(
        fac, _banded_rhs(plan, fac, b), split))


def _banded_factorize(plan: SolvePlan, data):
    """Sequential block elimination over the nb block rows: S_i = D_i -
    E_i C_{i-1}, its LU (with the static pivot perturbation of
    ``bcr.lu_static``), C_i = S_i^{-1} F_i. A batch (B, nnz) steps every
    matrix's rows together."""
    data, rs, cs = _equilibrate(plan, data)
    fdt = _factor_dtype(plan, data.dtype)
    blocks = _banded_scatter(plan, data).to(fdt)
    E, D, F = (blocks[..., j, :, :, :] for j in range(3))
    # static pivot perturbation threshold (MUMPS-style), per matrix, at the
    # factors' precision
    delta = (plan.pivot_epsilon * (1.0 + data.abs().amax(-1))).to(
        _REAL.get(fdt, fdt))
    lus, pivs, perms, Cs, bads = [], [], [], [], []
    C = None
    for i in range(plan.nb):
        Di = D[..., i, :, :]
        S = Di if C is None else Di - E[..., i, :, :] @ C
        # one block a matrix: the lu_static batch of each lane's m = 1
        lu, piv, perm, bad = _bcr.lu_static(S.unsqueeze(-3), delta)
        lu, piv, perm, bad = (lu[..., 0, :, :], piv[..., 0, :],
                              perm[..., 0, :], bad[..., 0])
        C = _bcr.lu_solve(lu, perm, F[..., i, :, :])
        lus.append(lu)
        pivs.append(piv)
        perms.append(perm)
        Cs.append(C)
        bads.append(bad)
    lus = torch.stack(lus, dim=-3)
    pivs = torch.stack(pivs, dim=-2)
    diag = torch.diagonal(lus, dim1=-2, dim2=-1)
    ld, ph = _logdet_update(diag, pivs)
    return {"lus": lus, "pivs": pivs, "perms": torch.stack(perms, dim=-2),
            "Cs": torch.stack(Cs, dim=-3), "E": E,
            "rs": rs, "cs": cs, "logdet": ld.sum(-1), "phase": _prod(ph),
            "min_pivot": diag.abs().amin(dim=(-2, -1)),
            "n_perturbed": torch.stack(bads, dim=-1).sum(-1,
                                                         dtype=torch.int32),
            "data": data}


def _banded_solve(plan: SolvePlan, fac, b):
    nb = plan.nb
    bp = _banded_rhs(plan, fac, b).to(fac["lus"].dtype)
    lus, perms, E, Cs = fac["lus"], fac["perms"], fac["E"], fac["Cs"]
    ys = []
    y = None
    for i in range(nb):
        bi = bp[..., i, :]
        rhs = bi if y is None else bi - _bcr._mv(E[..., i, :, :], y)
        y = _bcr.lu_solve(lus[..., i, :, :], perms[..., i, :],
                          rhs[..., None])[..., 0]
        ys.append(y)
    xs = [None] * nb
    x = None
    for i in range(nb - 1, -1, -1):
        x = ys[i] if x is None else ys[i] - _bcr._mv(Cs[..., i, :, :], x)
        xs[i] = x
    return _banded_x(plan, fac, torch.stack(xs, dim=-2))


def det_phase(plan: SolvePlan, fac) -> complex:
    """Full COMPLEX determinant phase (the MUMPS ICNTL(33) full complex
    determinant contract, interface_mumps.c:203-206). The K-embedded /
    planes engines (SPLU/GRIDMF/GENMF) compute |det| in the factorize
    loop but leave phase = 1 there; this post-pass recovers it from the
    stored diagonal INVERSE pivot blocks (each embeds the complex Minv_k,
    and phase(det A) = conj(prod_k phase(det Minv_k)); the symmetric
    fill-reducing permutation has sign^2 = 1 and static pivoting does no
    row swaps). Runs only on an explicit determinant request, on the
    factors' device, in complex128 (``torch.linalg.slogdet`` per front
    where the reference package fetches planes to the host). The factors
    of a batch are refused."""
    if fac["logdet"].dim():
        raise ValueError(f"det_phase takes the factors of one matrix, got "
                         f"a batch of {fac['logdet'].shape[0]}")
    if plan.splu_plan is not None and "blocks" in fac:
        pri = _splu.splu_det_phase(plan.splu_plan, fac).cpu()
        return complex(float(pri[0]), float(pri[1]))
    store = fac.get("levels", fac.get("classes"))
    if (store is not None and store and isinstance(store[0], dict)
            and store[0].get("sii") is not None):
        tot = None
        for st in store:
            sign = torch.linalg.slogdet(
                torch.complex(st["sir"], st["sii"])).sign.prod()
            tot = sign if tot is None else tot * sign
        return complex(tot.conj().cpu())
    return complex(fac["phase"].cpu())


def _check_data(data):
    if data.dim() not in (1, 2):
        raise ValueError(f"entry values (nnz,) or a batch (B, nnz) "
                         f"expected, got {tuple(data.shape)}")


def _check_rhs(fac, b):
    """A right-hand side per lane of the factors: (n,) for one matrix's,
    (B, n) for a batch's."""
    lanes = fac["rs"].shape[:-1]
    if b.shape[:-1] != lanes or b.dim() > 2:
        raise ValueError(
            f"right-hand side {tuple(b.shape)} does not match factors of "
            f"{'a batch of ' + str(lanes[0]) if lanes else 'one matrix'} "
            f"(scaling {tuple(fac['rs'].shape)}): a batch's factors take "
            "(B, n), one matrix's (n,)")


def numeric_factorize(plan: SolvePlan, data):
    """Numeric factorization of the entry values ``data`` (f64 or
    complex128 tensor, on the device to factorize on) laid out as
    (plan.rows, plan.cols): (nnz,), or a batch (B, nnz) of matrices of
    the plan's pattern, factorized in one numeric phase (statistics (B,)).
    Under mixed precision the factors (and their statistics) are
    f32/complex64 and ``fac["data"]``, the scaled entries the refinement
    reads, stays at the input precision.
    With an out-of-core GRIDMF plan one matrix's factors go to host memory
    (real values only: complex ones raise NotImplementedError), and a
    batch factorizes in core, as the reference package's vmapped phase
    does."""
    _check_data(data)
    return _numeric_factorize(plan, data,
                              plan.gridmf_ooc and data.dim() == 1)


def _numeric_factorize(plan: SolvePlan, data, out_of_core=False):
    """``numeric_factorize``, out of core only when asked: in core it is
    the factorization of the paths that the reference package runs under
    ``jit`` (Radau5's pair, BwEuler), where its out-of-core plans run in
    core."""
    if plan.genie == Genie.DENSE:
        return _dense_factorize(plan, data)
    if plan.genie == Genie.BANDED:
        if plan.use_bcr:
            return _banded_factorize_bcr(plan, data)
        return _banded_factorize(plan, data)
    data, rs, cs = _equilibrate(plan, data)
    d = data.to(_factor_dtype(plan, data.dtype))
    if plan.genie == Genie.GRIDMF and out_of_core:
        fac = _gridmf.gridmf_factorize_ooc(plan.gridmf_plan, d)
    elif plan.genie == Genie.GRIDMF:
        fac = _gridmf.gridmf_factorize(plan.gridmf_plan, d)
    elif plan.genie == Genie.GENMF:
        fac = _genmf.genmf_factorize(plan.genmf_plan, d)
    else:
        fac = _splu.splu_factorize(plan.splu_plan, d)
    fac["rs"] = rs
    fac["cs"] = cs
    fac["data"] = data  # scaled entries (kept for refinement)
    return fac


def numeric_factorize_pair(plan: SolvePlan, data_r, data_c):
    """Factorize TWO matrices with the same structure (Radau5's real and
    complex Newton matrices). For SPLU both run in ONE pass over the
    packed schedule (splu_factorize_multi) — the analog of the reference's
    concurrent real/complex factorization (radau5.rs, P5); the other
    genies factor them one after the other, as the reference package does.
    Each may be a batch (B, nnz)."""
    _check_data(data_r)
    _check_data(data_c)
    if plan.genie != Genie.SPLU:
        return (_numeric_factorize(plan, data_r),
                _numeric_factorize(plan, data_c))
    dr, rs_r, cs_r = _equilibrate(plan, data_r)
    dc, rs_c, cs_c = _equilibrate(plan, data_c)
    fr, fc = _splu.splu_factorize_multi(
        plan.splu_plan, (dr.to(_factor_dtype(plan, dr.dtype)),
                         dc.to(_factor_dtype(plan, dc.dtype))))
    fr["rs"], fr["cs"], fr["data"] = rs_r, cs_r, dr
    fc["rs"], fc["cs"], fc["data"] = rs_c, cs_c, dc
    return fr, fc


def _residual(plan: SolvePlan, fac, x, b):
    """Unscaled-rhs-space residual b - A x through the scaled entries:
    R(b - A x) = R b - As (C^{-1} x), then divided by R."""
    _, cols = _device_indices(plan, x.device)
    dtype = x.dtype
    u = x / fac["cs"].to(dtype)
    ax = _row_sum(plan, fac["data"] * u[..., cols])
    return (fac["rs"].to(dtype) * b.to(dtype) - ax) / fac["rs"].to(dtype)


def _solve_once(plan: SolvePlan, fac, b):
    if plan.genie == Genie.DENSE:
        return _dense_solve(plan, fac, b)
    if plan.genie == Genie.BANDED:
        if plan.use_bcr:
            return _banded_solve_bcr(plan, fac, b)
        return _banded_solve(plan, fac, b)
    out_dtype = fac["data"].dtype
    y = fac["rs"].to(out_dtype) * b.to(out_dtype)
    if plan.genie == Genie.GRIDMF and isinstance(fac["levels"],
                                                 _gridmf.HostLevels):
        x = _gridmf.gridmf_solve_ooc(plan.gridmf_plan, fac, y)
    elif plan.genie == Genie.GRIDMF:
        x = _gridmf.gridmf_solve(plan.gridmf_plan, fac, y)
    elif plan.genie == Genie.GENMF:
        x = _genmf.genmf_solve(plan.genmf_plan, fac, y)
    else:
        x = _splu.splu_solve(plan.splu_plan, fac, y)
    return fac["cs"].to(out_dtype) * x.to(out_dtype)


def factor_solve(plan: SolvePlan, fac, b, refine_steps=None):
    """Solve A x = b from a numeric factorization, with ``refine_steps``
    (default ``plan.refine_steps``) rounds of iterative refinement
    against the scaled matrix. Radau5 passes 0 for its Newton solves.
    The factors of a batch take right-hand sides (B, n), one lane each.

    Under mixed precision with no ``refine_steps`` the refinement is the
    reference package's adaptive one (``_refine_adaptive``), and
    ``factor_solve.refinement`` records its rounds."""
    _check_rhs(fac, b)
    adaptive = refine_steps is None and plan.mixed32
    if refine_steps is None:
        refine_steps = plan.refine_steps
    x = _solve_once(plan, fac, b)
    if adaptive:
        return _refine_adaptive(plan, fac, b, x)
    for _ in range(refine_steps):
        x = x + _solve_once(plan, fac, _residual(plan, fac, x, b))
    return x


factor_solve.refinement = {}


def _vdot(a, b):
    """conj(a) . b over the last dimension, one per lane."""
    return (a.conj() * b).sum(-1)


def _pick(mask, new, old):
    """``new`` on the lanes of ``mask`` (L,), ``old`` on the others."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new,
                       old)


def _refine_adaptive(plan: SolvePlan, fac, b, x):
    """The reference package's adaptive refinement of f32 factors at the
    input precision (its ``_factor_solve``, factor.py:1214-1423, the
    host-driven form), over the residual and the Arioli-Demmel-Duff
    backward error w = max_i |r_i| / (|As| |u| + |R b|)_i of the scaled
    system (its denominator made once, from the first solution), in three
    tiers:

    1. plain refinement while each round cuts w by half (by ten where
       CG is open), at most IR_MAX_STEPS rounds, down to 2 eps;
    2. flexible CG (Polak-Ribiere beta, the true residual each
       iteration, the best iterate kept) for numerically symmetric real
       systems whose w is still above w_accept = max(300, 3 sqrt(n)) eps,
       ending after two stalled iterations, a non-positive curvature or a
       divergence, at most CG_MAX iterations;
    3. FGMRES(FGMRES_M) cycles (modified Gram-Schmidt, Givens QR, the
       preconditioner the factors with one inner refinement round) while
       w is above w_accept and each cycle halves it, at most
       FGMRES_CYCLES.

    w is read on the host once a round. The rows' sums are the
    deterministic ``_row_sum``. A batch (B, n) refines each lane as the
    reference's vmapped loops do: a lane's rounds end with its own tests,
    and the batch runs while any lane does. Records the rounds in
    ``factor_solve.refinement``."""
    n = plan.n
    lead = x.shape[:-1]
    x = x.reshape(-1, n)
    b = b.reshape(-1, n)
    dtype = x.dtype
    rdt = _REAL.get(dtype, dtype)
    _, cols = _device_indices(plan, x.device)
    data = fac["data"]
    data = data.reshape(-1, data.shape[-1])
    rs = fac["rs"].reshape(-1, n).to(dtype)
    cs = fac["cs"].reshape(-1, n).to(dtype)
    rb = rs * b.to(dtype)
    fi = torch.finfo(rdt)
    eps, tiny = fi.eps, fi.tiny
    tol = 2.0 * eps
    w_accept = max(300.0, 3.0 * float(np.sqrt(n))) * eps
    use_cg = plan.symmetric_values and not dtype.is_complex
    denom = (_row_sum(plan, data.abs() * (x / cs).abs()[:, cols])
             + rb.abs()).clamp(min=tiny)

    def solve(v):
        return _solve_once(plan, fac, v.view(lead + (n,))).reshape(-1, n)

    def resid_w(v):
        """(residual, w) of the iterate ``v``."""
        r = rb - _row_sum(plan, data * (v / cs)[:, cols])
        return r / rs, (r.abs() / denom).amax(-1)

    def matvec(v):
        """A v through the scaled entries (A = R^-1 As C^-1)."""
        return _row_sum(plan, data * (v / cs)[:, cols]) / rs

    def fgmres_cycle(x0, r0):
        beta = torch.linalg.vector_norm(r0, dim=-1)
        bsafe = beta.clamp(min=tiny)
        V = [r0 / bsafe.to(dtype)[:, None]]
        Z = []
        zero = torch.zeros_like(beta, dtype=dtype)
        one = torch.ones_like(beta, dtype=dtype)
        R = [[zero] * FGMRES_M for _ in range(FGMRES_M)]
        g = [beta.to(dtype)] + [zero] * FGMRES_M
        gc, gs = [None] * FGMRES_M, [None] * FGMRES_M
        for j in range(FGMRES_M):
            # the preconditioner with one inner refinement round
            z = solve(V[j])
            z = z + solve(V[j] - matvec(z))
            Z.append(z)
            wv = matvec(z)
            h = []
            for i in range(j + 1):
                hij = _vdot(V[i], wv)
                wv = wv - hij[:, None] * V[i]
                h.append(hij)
            hn = torch.linalg.vector_norm(wv, dim=-1)
            V.append(wv / hn.clamp(min=tiny).to(dtype)[:, None])
            for i in range(j):
                t0 = gc[i] * h[i] + gs[i].conj() * h[i + 1]
                t1 = -gs[i] * h[i] + gc[i] * h[i + 1]
                h[i], h[i + 1] = t0, t1
            # the rotation [[c, conj(s)], [-s, c]] (c real) that zeroes hn
            a = h[j]
            absa = a.abs()
            den = torch.sqrt(absa ** 2 + hn ** 2)
            live = den > eps * 10.0 * (1.0 + beta / bsafe)
            dsafe = den.clamp(min=tiny)
            phase = torch.where(absa > tiny, a / absa.clamp(min=tiny).to(
                dtype), one)
            c = torch.where(live, absa / dsafe, torch.ones_like(absa))
            sn = torch.where(live, (hn / dsafe).to(dtype) * phase.conj(),
                             zero)
            gc[j], gs[j] = c, sn
            for i in range(j + 1):
                R[i][j] = h[i]
            R[j][j] = torch.where(live, c * a + sn.conj() * hn.to(dtype),
                                  zero)
            g[j + 1] = -sn * g[j]
            g[j] = c * g[j]
        y = [zero] * FGMRES_M
        for j in range(FGMRES_M - 1, -1, -1):
            acc = g[j]
            for k in range(j + 1, FGMRES_M):
                acc = acc - R[j][k] * y[k]
            ok = R[j][j].abs() > eps * 10.0
            y[j] = torch.where(ok, acc / torch.where(ok, R[j][j], one), zero)
        return x0 + sum(y[j][:, None] * Z[j] for j in range(FGMRES_M))

    resid, w = resid_w(x)
    # 1. plain refinement
    gain = 0.1 if use_cg else 0.5
    w_prev = torch.full_like(w, float("inf"))
    on = (w > tol) & (w < gain * w_prev)
    ir = 0
    while ir < IR_MAX_STEPS and bool(on.any()):
        x2 = x + solve(resid)
        r2, w2 = resid_w(x2)
        x, resid = _pick(on, x2, x), _pick(on, r2, resid)
        w_prev, w = torch.where(on, w, w_prev), torch.where(on, w2, w)
        ir += 1
        on = on & (w > tol) & (w < gain * w_prev)
    # 2. flexible CG
    cg = 0
    if use_cg and bool((w > w_accept).any()):
        cg_lanes = w > w_accept
        on = cg_lanes.clone()
        z = solve(resid)
        p = z
        rz = _vdot(resid, z)
        x_best, w_best = x, w
        stall = torch.zeros_like(w, dtype=torch.int32)
        for _ in range(CG_MAX):
            pAp = _vdot(p, matvec(p))
            on = on & (pAp > 0.0) & (rz > 0.0)  # indefinite: keep the best
            if not bool(on.any()):
                break
            alpha = rz / torch.where(on, pAp, 1.0)
            x = _pick(on, x + alpha[:, None] * p, x)
            r2, w2 = resid_w(x)
            resid, w = _pick(on, r2, resid), torch.where(on, w2, w)
            stall = torch.where(on, torch.where(w < 0.7 * w_best, 0,
                                                stall + 1), stall)
            better = on & (w < w_best)
            x_best = _pick(better, x, x_best)
            w_best = torch.where(better, w, w_best)
            cg += 1
            on = on & (w_best > w_accept) & (w <= 1e3 * w_best) & (stall < 2)
            if not bool(on.any()):
                break
            z2 = solve(resid)
            beta = _vdot(resid, z2 - z) / rz
            rz = torch.where(on, _vdot(resid, z2), rz)
            p = _pick(on, z2 + beta[:, None] * p, p)
            z = _pick(on, z2, z)
        x = _pick(cg_lanes, x_best, x)
        w = torch.where(cg_lanes, w_best, w)
        resid = _pick(cg_lanes, resid_w(x)[0], resid)
    # 3. FGMRES-IR
    w_prev = torch.full_like(w, float("inf"))
    on = (w > w_accept) & (w < 0.5 * w_prev)
    cycles = 0
    while cycles < FGMRES_CYCLES and bool(on.any()):
        x2 = fgmres_cycle(x, resid)
        r2, w2 = resid_w(x2)
        x, resid = _pick(on, x2, x), _pick(on, r2, resid)
        w_prev, w = torch.where(on, w, w_prev), torch.where(on, w2, w)
        cycles += 1
        on = on & (w > w_accept) & (w < 0.5 * w_prev)
    factor_solve.refinement = {"ir": ir, "cg": cg, "fgmres": cycles,
                               "w": float(w.max())}
    return x.view(lead + (n,))


def factor_solve_batch(plan: SolvePlan, data, b):
    """Factorize and solve a batch of systems of one structure: entry
    values ``data`` (B, nnz) and right-hand sides ``b`` (B, n), returning
    x (B, n), with the plan's rounds of refinement. Every genie runs one
    batched numeric phase and one batched solve over the one plan. For
    ``parallel.batch_factor_solve``, which gives each rank its rows."""
    if data.dim() != 2:
        raise ValueError(f"a batch of entry values (B, nnz) expected, got "
                         f"{tuple(data.shape)}")
    return factor_solve(plan, numeric_factorize(plan, data), b)


def factor_solve_pair(plan: SolvePlan, fac_r, fac_c, b_r, b_c,
                      refine_steps=None):
    """Solve the real and complex systems TOGETHER (for SPLU one
    packed-substitution pass per refinement round covers both; the other
    genies solve them one after the other, as the reference package
    does). Batched factors take right-hand sides (B, n)."""
    _check_rhs(fac_r, b_r)
    _check_rhs(fac_c, b_c)
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
