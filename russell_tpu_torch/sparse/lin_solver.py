"""Unified sparse linear solver: params, stats, and the LinSolTrait
contract, in PyTorch.

Counterpart of ``russell_tpu.sparse.lin_solver`` (reference contract:
russell_sparse/src/lin_solver.rs:12-105):

- ``factorize(matrix, params)`` may be called repeatedly, but the structure
  (nrow/ncol/nnz/sym and positions) must not change between calls
  (lin_solver.rs:17-28): the first call runs the host symbolic phase, later
  ones only the numeric factorization on the device (and reuse the
  device copy of the values when they are unchanged).
- ``solve(rhs)`` requires a prior ``factorize``.
- ``LinSolver(genie, device)`` dispatches to a factorization path
  (lin_solver.rs:105): DENSE, BANDED, SPLU, GRIDMF or GENMF, AUTO routing
  as the reference package does (``factor.analyze``). The device is the
  card unless the caller names another.
- Stats mirror StatsLinSol (stats_lin_sol.rs:105), including the
  (mantissa, base, exponent) determinant of MUMPS ICNTL(33)/UMFPACK and
  the MUMPS ICNTL(11)-style error analysis.

Complex systems work through the same class (dtype dispatch), covering the
reference's ComplexLinSolver (complex_lin_solver.rs), in native
complex128. Factors are f64 / complex128: ``mixed_precision=True`` (the
reference package's f32 factors and their precision escalation) raises
``NotImplementedError``. GRIDMF factors past ``factor.GRIDMF_BUDGET_GB``
live in host memory (``stats.output["out_of_core"]``; real matrices
only), and each solve ships them back level by level.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.core.stopwatch import format_nanoseconds
from russell_tpu_torch.sparse import factor as _factor
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.csr import CsrMatrix
from russell_tpu_torch.sparse.enums import Genie, Ordering, Scaling, Sym

__all__ = ["LinSolParams", "StatsLinSol", "LinSolver"]


@dataclass
class LinSolParams:
    """Solver options (reference: lin_sol_params.rs:5-70); the fields and
    defaults of ``russell_tpu.sparse.LinSolParams``. Radau5 reads it from
    ``ParamsNewton.lin_sol_params``."""

    ordering: Ordering = Ordering.AUTO
    scaling: Scaling = Scaling.AUTO
    pivot_epsilon: float = 1e-14
    refinement_nstep: int = 2
    positive_definite: bool = False
    compute_determinant: bool = False
    # error analysis at solve time (MUMPS ICNTL(11) analog): backward
    # errors omega1/omega2 (Arioli-Demmel-Duff), scaled residual, and the
    # normalized forward-error estimate |dx|/|x|
    compute_error_estimates: bool = False
    # condition-number estimates cond1/cond2 via power iteration on
    # A^{-1} through the solve (estimates from below)
    compute_condition_numbers: bool = False
    verbose: bool = False
    # path tuning: AUTO takes DENSE at n <= dense_threshold, and above it
    # BANDED when the RCM bandwidth is at most max_block, else GENMF
    dense_threshold: int = 1200
    max_block: int = 4096
    # structure hint (*dims, s) — 2-D (nr, nc, s) or 3-D (n0, n1, n2, s) —
    # for grid-stencil matrices (species-major layout var = k*prod(dims)
    # + row_major_cell); unlocks the GRIDMF multifrontal path
    grid: Optional[tuple] = None
    # None or False: f64 factors. True (f32 factors) is not ported.
    mixed_precision: Optional[bool] = None


@dataclass
class StatsLinSol:
    """Benchmark/stats record (reference: stats_lin_sol.rs:105), with the
    reference package's JSON keys."""

    main: dict = field(default_factory=lambda: {
        "platform": "russell_tpu_torch", "blas_lib": "", "solver": ""})
    matrix: dict = field(default_factory=lambda: {
        "name": "", "nrow": 0, "ncol": 0, "nnz": 0, "complx": False,
        "symmetric": "No"})
    requests: dict = field(default_factory=lambda: {
        "ordering": "Auto", "scaling": "Auto"})
    output: dict = field(default_factory=lambda: {
        "effective_ordering": "", "effective_scaling": "",
        "min_pivot": 0.0, "n_perturbed_pivots": 0,
        "umfpack_rcond_estimate": 0.0})
    determinant: dict = field(default_factory=lambda: {
        "mantissa_real": 0.0, "mantissa_imag": 0.0, "base": 10.0,
        "exponent": 0.0})
    verify: dict = field(default_factory=dict)
    # error-analysis record; field names mirror the reference's
    # StatsLinSolMUMPS (stats_lin_sol.rs:198-205, MUMPS RINFOG analogs)
    mumps_stats: dict = field(default_factory=lambda: {
        "inf_norm_a": 0.0, "inf_norm_x": 0.0, "scaled_residual": 0.0,
        "backward_error_omega1": 0.0, "backward_error_omega2": 0.0,
        "normalized_delta_x": 0.0, "condition_number1": 0.0,
        "condition_number2": 0.0})
    time_nanoseconds: dict = field(default_factory=lambda: {
        "initialize": 0, "factorize": 0, "solve": 0})

    @property
    def time_human(self) -> dict:
        return {k: format_nanoseconds(v)
                for k, v in self.time_nanoseconds.items()}

    def get_json(self) -> str:
        d = asdict(self)
        d["time_human"] = self.time_human
        return json.dumps(d, indent=2)


def _expand_full_pattern(rows, cols, coo_order_vals, sym: Sym):
    """Mirror triangular symmetric storage into the full pattern.

    Returns (rows_full, cols_full, mirror_map) where value arrays in COO
    order extend to full order via vals_full = concat(vals, vals[mirror_map]).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if sym.triangular():
        off = np.nonzero(rows != cols)[0]
        rows_full = np.concatenate([rows, cols[off]])
        cols_full = np.concatenate([cols, rows[off]])
        return rows_full, cols_full, off
    return rows, cols, None


def _numeric_symmetry(n, rows, cols, vals) -> bool:
    """Host check that the assembled values satisfy A == A^T (duplicates
    summed). Real matrices only — complex symmetric does not admit CG."""
    vals = np.asarray(vals)
    if vals.dtype.kind == "c" or len(vals) > 20_000_000:
        return False
    key = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    a = np.bincount(inv, weights=vals.astype(np.float64),
                    minlength=uk.shape[0])
    tk = (uk % n) * n + uk // n
    order = np.argsort(tk)
    if not np.array_equal(tk[order], uk):
        return False
    scale = float(np.max(np.abs(a))) or 1.0
    return bool(np.max(np.abs(a - a[order])) <= 1e-12 * scale)


def _values_dtype(v):
    return torch.complex128 if (v.is_complex() if isinstance(
        v, torch.Tensor) else np.iscomplexobj(v)) else torch.float64


class LinSolver:
    """Sparse direct solver with the LinSolTrait contract, on ``device``
    (the card unless the caller names another; no fallback)."""

    def __init__(self, genie: Genie | str = Genie.AUTO, device="cuda"):
        if isinstance(genie, str):
            genie = Genie.from_name(genie)
        self.genie = genie
        self.device = russell_tpu_torch.device(device)
        self.plan: Optional[_factor.SolvePlan] = None
        self.fac = None
        self._structure = None
        self._mirror = None          # mirror map of triangular storage
        self._params = None
        self._vals_digest = None
        self._vals_full = None
        self.stats = StatsLinSol()
        self.stats.main["blas_lib"] = (
            "cuBLAS/cuSOLVER" if self.device.type == "cuda" else "torch CPU")
        self._factorized = False

    # -- factorize -----------------------------------------------------------

    def factorize(self, mat, params: Optional[LinSolParams] = None):
        """Factorize a CooMatrix or CsrMatrix (square).

        The first call runs the host symbolic phase; later calls require
        the *same* structure (lin_solver.rs:17-28) and only re-run the
        numeric factorization."""
        params = params or LinSolParams()
        if params.mixed_precision:
            raise NotImplementedError(
                "mixed-precision factors are not ported: the port "
                "factorizes in f64 (ROADMAP.md)")
        t0 = time.perf_counter_ns()
        if isinstance(mat, CooMatrix):
            ii, jj, vv = mat.triplets()
            nrow, ncol, sym = mat.nrow, mat.ncol, mat.sym
        elif isinstance(mat, CsrMatrix):
            ii, jj = mat.row_ids, mat.indices
            vv = mat.data
            nrow, ncol, sym = mat.nrow, mat.ncol, mat.sym
        else:
            raise TypeError("matrix must be CooMatrix or CsrMatrix")
        if nrow != ncol:
            raise ValueError("the matrix must be square")
        structure = (nrow, np.asarray(ii).tobytes(),
                     np.asarray(jj).tobytes(), sym)
        if self.plan is None:
            rows_full, cols_full, mirror = _expand_full_pattern(
                ii, jj, vv, sym)
            if mirror is not None:
                self._mirror = torch.as_tensor(mirror, device=self.device)
            self.plan = plan = _factor.analyze(
                nrow, rows_full, cols_full, genie=self.genie,
                ordering=params.ordering, scaling=params.scaling,
                pivot_epsilon=params.pivot_epsilon,
                refine_steps=params.refinement_nstep,
                dense_threshold=params.dense_threshold,
                max_block=params.max_block, grid=params.grid,
                mixed_precision=params.mixed_precision)
            self._structure = structure
            self.stats.main["solver"] = plan.genie.value
            self.stats.matrix.update(
                nrow=nrow, ncol=ncol, nnz=int(len(ii)),
                complx=_values_dtype(vv) == torch.complex128,
                symmetric=sym.name)
            self.stats.requests.update(
                ordering=params.ordering.name, scaling=params.scaling.name)
            self.stats.output["effective_ordering"] = plan.effective_ordering
            self.stats.output["effective_scaling"] = plan.scaling.name
            if plan.gridmf_ooc:
                # GRIDMF factors past the device budget: in host memory
                self.stats.output["out_of_core"] = True
            self.stats.time_nanoseconds["initialize"] = (
                time.perf_counter_ns() - t0)
        elif structure != self._structure:
            raise ValueError("subsequent factorizations must use the same "
                             "structure")

        t1 = time.perf_counter_ns()
        self._params = params
        self._vals_full = self._device_values(vv)
        # the old factors go before the new ones are made: one store at a
        # time in device memory, or in host memory out of core
        self.fac = None
        self._factorized = False
        self.fac = _factor.numeric_factorize(self.plan, self._vals_full)
        self._factorized = True
        mp = float(self.fac["min_pivot"])    # waits for the factorization
        self.stats.output["min_pivot"] = mp
        if "n_perturbed" in self.fac:
            self.stats.output["n_perturbed_pivots"] = int(
                self.fac["n_perturbed"])
        self.stats.time_nanoseconds["factorize"] = time.perf_counter_ns() - t1
        if params.compute_determinant:
            self._store_determinant()
        if mp == 0.0:
            raise RuntimeError("factorization failed: matrix is singular")
        return self

    def _device_values(self, vv):
        """The full-pattern values on the solver's device. Unchanged host
        values (same digest) reuse the device buffer of the last call; the
        numeric phase still re-runs in full."""
        dtype = _values_dtype(vv)
        if isinstance(vv, torch.Tensor):
            vals = vv.to(self.device, dtype)
            self._vals_digest = None
        else:
            arr = np.ascontiguousarray(vv)
            digest = hashlib.blake2b(arr.tobytes(), digest_size=16).digest()
            if digest == self._vals_digest and self._vals_full is not None:
                return self._vals_full
            vals = torch.as_tensor(arr, device=self.device).to(dtype)
            self._vals_digest = digest
        if self._mirror is not None:
            vals = torch.cat([vals, vals[self._mirror]])
        return vals

    def _store_determinant(self):
        # det = phase * exp(logdet) -> (mantissa, 10, exponent); the scaled
        # matrix's determinant is unscaled: det(A) = det(As)/(prod rs cs)
        logdet = float(self.fac["logdet"])
        phase = _factor.det_phase(self.plan, self.fac)
        rs = self.fac["rs"].to(torch.float64)
        cs = self.fac["cs"].to(torch.float64)
        log_scale = float(torch.log(rs).sum() + torch.log(cs).sum())
        log10 = (logdet - log_scale) / np.log(10.0)
        exponent = np.floor(log10)
        mantissa = phase * 10.0 ** (log10 - exponent)
        self.stats.determinant.update(
            mantissa_real=float(mantissa.real),
            mantissa_imag=float(mantissa.imag),
            base=10.0, exponent=float(exponent))

    def determinant(self):
        """(mantissa, base, exponent) with det = mantissa * base**exponent."""
        self._store_determinant()
        d = self.stats.determinant
        m = d["mantissa_real"] + 1j * d["mantissa_imag"]
        if abs(m.imag) == 0.0:
            m = m.real
        return m, d["base"], d["exponent"]

    # -- solve ----------------------------------------------------------------

    def _rhs(self, rhs):
        return torch.as_tensor(rhs).to(self.device, self._vals_full.dtype)

    def solve(self, rhs, verbose: bool = False):
        """x = A^{-1} rhs on the solver's device (requires factorize
        first); ``rhs`` is a numpy array or a tensor, x a tensor."""
        if not self._factorized:
            raise RuntimeError("factorize must be called before solve")
        t0 = time.perf_counter_ns()
        b = self._rhs(rhs)
        x = _factor.factor_solve(self.plan, self.fac, b)
        float(x.abs().max())                  # waits for the solve
        self.stats.time_nanoseconds["solve"] = time.perf_counter_ns() - t0
        p = self._params
        if p is not None and (p.compute_error_estimates
                              or p.compute_condition_numbers):
            self._error_analysis(x, b, p.compute_condition_numbers)
        return x

    def solve_planes(self, b_re, b_im):
        """The complex solve of ``b_re + i b_im`` as (x_re, x_im) float64
        planes (the reference package's plane interface, over the native
        complex128 solve)."""
        if not self._factorized:
            raise RuntimeError("factorize must be called before solve")
        b = torch.complex(torch.as_tensor(b_re).to(self.device,
                                                   torch.float64),
                          torch.as_tensor(b_im).to(self.device,
                                                   torch.float64))
        x = self.solve(b)
        return x.real, x.imag

    def _backward_error(self, x, b) -> float:
        """Componentwise (Arioli-Demmel-Duff omega_1) backward error of the
        UNSCALED system — one SpMV pair."""
        plan = self.plan
        _, cols = _factor._device_indices(plan, self.device)
        vals = self._vals_full
        xj = torch.as_tensor(x).to(self.device, vals.dtype)
        bj = torch.as_tensor(b).to(self.device, vals.dtype)
        ax = _factor._row_sum(plan, vals * xj[cols])
        denom = _factor._row_sum(plan, vals.abs() * xj.abs()[cols]) + bj.abs()
        tiny = torch.finfo(denom.dtype).tiny
        return float(((bj - ax).abs() / denom.clamp(min=tiny)).max())

    def _error_analysis(self, x, b, with_cond: bool):
        """MUMPS ICNTL(11)-style error analysis (RINFOG(4..11) analogs;
        Arioli-Demmel-Duff backward errors). Condition numbers are
        power-iteration estimates of ||A^{-1}|| through the solve —
        estimates from below, like all norm estimators."""
        plan = self.plan
        n = plan.n
        _, cols = _factor._device_indices(plan, self.device)
        vals = self._vals_full
        absv = vals.abs()
        eps = float(torch.finfo(absv.dtype).eps)
        bj = b.to(x.dtype)

        ax = _factor._row_sum(plan, vals.to(x.dtype) * x[cols])
        r = bj - ax
        absr = r.abs()
        abs_ax = _factor._row_sum(plan, absv * x.abs()[cols])
        row_norm = _factor._row_sum(plan, absv)
        inf_a = float(row_norm.max())
        inf_x = float(x.abs().max())

        # Arioli-Demmel-Duff split: rows whose componentwise denominator
        # (|A||x| + |b|)_i is non-negligible feed omega1; degenerate rows
        # feed omega2 with the (|A||x|)_i + ||A_i||_inf ||x||_inf bound
        den1 = abs_ax + bj.abs()
        den2 = abs_ax + row_norm * inf_x
        small = den1 <= (n * eps) * den2
        zero = torch.zeros((), dtype=absr.dtype, device=absr.device)
        w1 = torch.where(small | (den1 == 0), zero,
                         absr / den1.clamp(min=eps))
        w2 = torch.where(small & (den2 > 0), absr / den2.clamp(min=eps),
                         zero)
        ms = self.stats.mumps_stats
        ms["inf_norm_a"] = inf_a
        ms["inf_norm_x"] = inf_x
        ms["scaled_residual"] = float(absr.max()) / max(inf_a * inf_x, eps)
        ms["backward_error_omega1"] = float(w1.max())
        ms["backward_error_omega2"] = float(w2.max())
        # forward-error estimate |dx|/|x| from one refinement correction
        dx = _factor.factor_solve(self.plan, self.fac, r)
        ms["normalized_delta_x"] = float(dx.abs().max()) / max(inf_x, eps)
        if with_cond:
            col_norm = _factor._col_sum(plan, absv)
            one_a = float(col_norm.max())
            # ||A^{-1}|| from below: power iteration through the solve
            rng = np.random.default_rng(12345)
            v = torch.as_tensor(rng.choice([-1.0, 1.0], size=n),
                                device=self.device).to(x.dtype)
            est_inf = est_one = 0.0
            for _ in range(4):
                w = _factor.factor_solve(self.plan, self.fac, v)
                nw_inf = float(w.abs().max())
                nw_one = float(w.abs().sum())
                nv_inf = float(v.abs().max())
                nv_one = float(v.abs().sum())
                est_inf = max(est_inf, nw_inf / max(nv_inf, eps))
                est_one = max(est_one, nw_one / max(nv_one, eps))
                v = w / max(nw_inf, eps)
            ms["condition_number1"] = inf_a * est_inf
            ms["condition_number2"] = one_a * est_one
            self.stats.output["umfpack_rcond_estimate"] = (
                1.0 / max(inf_a * est_inf, eps))

    def kernel_fns(self):
        """(factorize_fn, solve_fn) pure functions bound to the frozen
        plan: factorize_fn takes the values in the matrix's own (COO or
        CSR) order as a tensor on the solver's device."""
        plan = self.plan
        if plan is None:
            raise RuntimeError("factorize must be called once to fix the "
                               "structure")
        mirror = self._mirror

        def fact(vals):
            if mirror is not None:
                vals = torch.cat([vals, vals[mirror]])
            return _factor.numeric_factorize(plan, vals)

        def solve(fac, b):
            return _factor.factor_solve(plan, fac, b)

        return fact, solve
