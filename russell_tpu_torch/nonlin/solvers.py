"""Natural and pseudo-arclength continuation steppers.

Reference contracts: russell_nonlin/src/solver_natural.rs and
solver_arclength.rs:148 — Euler predictor + Newton corrector; arclength
uses either the bordering algorithm (two Gu solves per iteration,
solver_arclength.rs:556-600) or the augmented (ndim+1) bordered matrix.

Counterpart of ``russell_tpu.nonlin.solvers``. Gu's factorizations and
solves run through the port's ``factor`` (``analyze`` once per solver,
``numeric_factorize`` and ``factor_solve`` on the solver's device) on the
frozen structure; G and the Jacobian are computed on that device too. The
tangent and controller logic runs on the host in f64, as in the
reference: u lives on the host, and each evaluation copies it to the
device and its result back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.nonlin.config import (CONFIG_H_MIN, Config, IniDir,
                                             Method, Status, Stop)
from russell_tpu_torch.nonlin.stats import Workspace
from russell_tpu_torch.nonlin.system import System
from russell_tpu_torch.sparse import factor as _factor
from russell_tpu_torch.sparse.enums import Sym

__all__ = ["SolverNatural", "SolverArclength"]


def _expand_sym(system: System):
    """Full pattern for triangular-symmetric Gu storage."""
    ii, jj = system.jac_ii, system.jac_jj
    if system.sym_ggu.triangular():
        off = np.nonzero(ii != jj)[0]
        return (np.concatenate([ii, jj[off]]), np.concatenate([jj, ii[off]]),
                off)
    return ii, jj, None


def _host(t) -> np.ndarray:
    """A host f64 copy of the tensor ``t``."""
    return t.to(torch.float64).cpu().numpy()


def _tensor(u, device):
    """The host f64 vector ``u`` as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(u, dtype=np.float64), device=device)


def _maybe_write_gu(config: Config, system: System, vals, n_accepted: int,
                    tag: str):
    """Dump-and-die debugging (solver_natural.rs:95-105)."""
    nstep = config.write_matrix_after_nstep_and_stop
    if nstep is None or nstep <= n_accepted:
        return
    import os
    import tempfile
    from russell_tpu_torch.sparse.coo import CooMatrix
    from russell_tpu_torch.sparse.matrix_market import write_matrix_market
    out = os.path.join(tempfile.gettempdir(), "russell_tpu_torch")
    os.makedirs(out, exist_ok=True)
    gu = CooMatrix.from_arrays(system.ndim, system.ndim, system.jac_ii,
                               system.jac_jj, _host(vals), system.sym_ggu)
    key = os.path.join(out, f"ggu_{tag}-{n_accepted:03d}")
    write_matrix_market(gu, key + ".mtx")
    write_matrix_market(gu, key + ".smat", vismatrix=True)
    raise RuntimeError(f"MATRIX FILES GENERATED in {out}")


class _GuSolver:
    """Frozen-structure factorize/solve for the Gu matrix on ``device``."""

    def __init__(self, system: System, config: Config, device):
        ii, jj, mirror = _expand_sym(system)
        self.device = device
        self.plan = _factor.analyze(system.ndim, ii, jj, genie=config.genie)
        _factor.prepare(self.plan, device)
        self.mirror = (None if mirror is None
                       else torch.as_tensor(mirror, device=device))
        self.fac = None

    def factorize(self, vals):
        vals = torch.as_tensor(vals).to(self.device, torch.float64)
        if self.mirror is not None:
            vals = torch.cat([vals, vals[self.mirror]])
        self.fac = _factor.numeric_factorize(self.plan, vals)
        if float(self.fac["min_pivot"]) == 0.0:
            raise RuntimeError("factorization failed: Gu is singular")

    def solve(self, b) -> np.ndarray:
        b = torch.as_tensor(b).to(self.device, torch.float64)
        return _host(_factor.factor_solve(self.plan, self.fac, b))


class SolverNatural:
    """Natural parameter continuation (solver_natural.rs)."""

    def __init__(self, config: Config, system: System, device):
        assert config.method == Method.NATURAL
        self.config = config
        self.system = system
        self.device = device
        self.sign0 = 1.0
        self.iter_jac_computed = False
        self.ggl = np.zeros(system.ndim)
        self.ls = _GuSolver(system, config, device)
        self.u_prev = np.zeros(system.ndim)

    def _assemble_and_factorize(self, work: Workspace, args):
        work.stats.sw_jacobian.reset()
        work.stats.n_jacobian += 1
        vals, ggl = self.system.calc_jac(work.l,
                                         _tensor(work.u, self.device),
                                         args)
        self.ggl = _host(ggl)
        work.stats.stop_sw_jacobian()
        _maybe_write_gu(self.config, self.system, vals,
                        work.stats.n_accepted, "natural")
        work.stats.sw_factor.reset()
        work.stats.n_factor += 1
        self.ls.factorize(vals)
        work.stats.stop_sw_factor()

    def _iterate(self, work: Workspace, u, l, args) -> Status:
        work.stats.n_function += 1
        work.gg = _host(self.system.calc_gg(
            work.l, _tensor(work.u, self.device), args))
        if work.err.analyze_residual(work.n_iteration, work.gg, 0.0):
            return Status.NAN_OR_INF_RESIDUAL
        if work.err.converged():
            return Status.SUCCESS
        self._assemble_and_factorize(work, args)
        self.iter_jac_computed = True
        work.stats.sw_lin_sol.reset()
        work.stats.n_lin_sol += 1
        mdu = self.ls.solve(work.gg)
        work.stats.stop_sw_lin_sol()
        if work.err.analyze_delta(work.n_iteration, mdu):
            return Status.NAN_OR_INF_DELTA
        if work.err.converged():
            return Status.SUCCESS
        status = work.err.capture_failures(work.n_iteration)
        if status.failure():
            return status
        work.u = work.u - mdu
        return Status.SUCCESS

    def initialize(self, work: Workspace, ddl_ini: float, u, l: float,
                   direction: IniDir, args):
        self.iter_jac_computed = False
        self.sign0 = 1.0 if direction == IniDir.POS else -1.0
        work.h = ddl_ini

    def step(self, work: Workspace, u, l: float, stop: Stop, args) -> Status:
        work.err.reset(u, l)
        work.stats.record_iterations_residuals_start()
        work.l = l + self.sign0 * work.h
        # targeting-lambda mode (solver_natural.rs:263)
        t = stop.lambda_target()
        if t is not None:
            l1, is_min = t
            if (work.l <= l1 and is_min) or (work.l >= l1 and not is_min):
                work.h = (l1 - l) * self.sign0
                work.l = l + self.sign0 * work.h
                work.target_reached = True
        if self.config.euler_predictor:
            if not self.iter_jac_computed:
                work.u = np.asarray(u).copy()
                self._assemble_and_factorize(work, args)
                self.iter_jac_computed = True
            ddl = work.l - l
            mdu = self.ls.solve(self.ggl)
            work.u = np.asarray(u) - ddl * mdu
        else:
            work.u = np.asarray(u).copy()
        status = Status.SUCCESS
        work.n_iteration = 0
        for _ in range(self.config.n_iteration_max):
            work.stats.n_iteration_total += 1
            status = self._iterate(work, u, l, args)
            if status.failure():
                break
            work.stats.record_iterations_residuals_append(
                work.err.residual_max)
            if work.err.converged():
                break
            work.n_iteration += 1
        work.stats.record_iterations_residuals_stop(work.err.converged())
        return status

    def accept(self, work: Workspace, u, l: float, args):
        """Returns (u1, l1, rdiff)."""
        # curvature-based relative error (solver_natural.rs:calculate_rerr)
        rdiff = 0.0
        if work.stats.n_accepted > 1:
            den = np.abs(work.u - u)
            ok = den > CONFIG_H_MIN
            if np.any(ok):
                num = np.abs(work.u - 2.0 * u + self.u_prev)
                rdiff = float(np.max(num[ok] / den[ok])) \
                    / self.config.tg_control_tol
        self.u_prev = np.asarray(u).copy()
        return work.u.copy(), work.l, rdiff

    def reject(self, work: Workspace, args):
        pass


class SolverArclength:
    """Pseudo-arclength continuation with the bordering algorithm
    (solver_arclength.rs:148)."""

    def __init__(self, config: Config, system: System, device):
        assert config.method == Method.ARCLENGTH
        if not config.bordering and system.sym_ggu != Sym.NO:
            raise ValueError("the Arclength method requires sym_ggu = No "
                             "when not using bordering")
        self.config = config
        self.system = system
        self.device = device
        self.theta = 1.0
        self.iter_jac_computed = False
        self.ggl = np.zeros(system.ndim)
        self.duds_prev = np.zeros(system.ndim)
        self.dlds_prev = 0.0
        self.ls = _GuSolver(system, config, device)
        # augmented path shares the bordering Gu solves (the reference
        # package's choice: the bordering algorithm reuses one frozen n x n
        # structure; russell's explicit (n+1) x (n+1) assembly is
        # equivalent)

    def _assemble_and_factorize(self, work: Workspace, args):
        work.stats.sw_jacobian.reset()
        work.stats.n_jacobian += 1
        vals, ggl = self.system.calc_jac(work.l,
                                         _tensor(work.u, self.device),
                                         args)
        self.ggl = _host(ggl)
        work.stats.stop_sw_jacobian()
        _maybe_write_gu(self.config, self.system, vals,
                        work.stats.n_accepted, "arclength")
        work.stats.sw_factor.reset()
        work.stats.n_factor += 1
        self.ls.factorize(vals)
        work.stats.stop_sw_factor()

    def _calc_initial_tangent(self, work: Workspace, sign0: float, args):
        self._assemble_and_factorize(work, args)
        work.stats.sw_lin_sol.reset()
        work.stats.n_lin_sol += 1
        mdu = self.ls.solve(self.ggl)  # mdu = -z0
        work.stats.stop_sw_lin_sol()
        work.dlds = sign0 / math.sqrt(1.0 + float(mdu @ mdu))
        work.duds = -work.dlds * mdu
        if abs(work.dlds) < CONFIG_H_MIN:
            raise RuntimeError("initial dlambda/ds is zero")
        if np.max(np.abs(work.duds)) < CONFIG_H_MIN:
            raise RuntimeError("initial du/ds vector is zero")

    def _update_tangent(self, work: Workspace, args):
        self.duds_prev = work.duds.copy()
        self.dlds_prev = work.dlds
        if not self.iter_jac_computed:
            self._assemble_and_factorize(work, args)
        work.stats.sw_lin_sol.reset()
        work.stats.n_lin_sol += 1
        mdu = self.ls.solve(self.ggl)  # mdu = -z
        work.stats.stop_sw_lin_sol()
        work.dlds = 1.0 / math.sqrt(1.0 + float(mdu @ mdu))
        work.duds = -work.dlds * mdu
        dot = float(work.duds @ self.duds_prev) + work.dlds * self.dlds_prev
        if dot < 0.0:
            work.duds = -work.duds
            work.dlds = -work.dlds

    def _iterate(self, work: Workspace, u, l, args) -> Status:
        work.stats.n_function += 1
        work.gg = _host(self.system.calc_gg(
            work.l, _tensor(work.u, self.device), args))
        # constraint N = theta (u-u0).duds0 + (2-theta)(l-l0) dlds0 - sigma
        du_part = 0.0
        if self.theta > 0.0:
            du_part = float((work.u - u) @ work.duds)
        sigma = work.h
        nn = (self.theta * du_part
              + (2.0 - self.theta) * (work.l - l) * work.dlds - sigma)
        if work.err.analyze_residual(work.n_iteration, work.gg, nn):
            return Status.NAN_OR_INF_RESIDUAL
        if work.err.converged():
            return Status.SUCCESS
        self._assemble_and_factorize(work, args)
        self.iter_jac_computed = True
        work.stats.sw_lin_sol.reset()
        work.stats.n_lin_sol += 2
        dua = self.ls.solve(self.ggl)      # Gu^-1 Glambda
        dub = self.ls.solve(work.gg)       # Gu^-1 G
        work.stats.stop_sw_lin_sol()
        nnl = (2.0 - self.theta) * work.dlds
        den = self.theta * float(work.duds @ dua) - nnl
        if abs(den) < CONFIG_H_MIN:
            return Status.BORDERING_SMALL_DENOMINATOR
        dl = (nn - self.theta * float(work.duds @ dub)) / den
        x = np.empty(self.system.ndim + 1)
        x[:-1] = -dl * dua - dub
        x[-1] = dl
        if work.err.analyze_delta(work.n_iteration, x):
            return Status.NAN_OR_INF_DELTA
        if work.err.converged():
            return Status.SUCCESS
        status = work.err.capture_failures(work.n_iteration)
        if status.failure():
            return status
        work.u = work.u + x[:-1]
        work.l += x[-1]
        return Status.SUCCESS

    def initialize(self, work: Workspace, ddl_ini: float, u, l: float,
                   direction: IniDir, args):
        self.theta = 1.0
        self.iter_jac_computed = False
        work.u = np.asarray(u).copy()
        work.l = l
        self._calc_initial_tangent(
            work, 1.0 if direction == IniDir.POS else -1.0, args)
        work.h = ddl_ini / abs(work.dlds)

    def step(self, work: Workspace, u, l: float, stop: Stop, args) -> Status:
        work.err.reset(u, l)
        work.stats.record_iterations_residuals_start()
        work.l = l + (2.0 - self.theta) * work.h * work.dlds
        t = stop.lambda_target()
        if t is not None:
            l1, is_min = t
            if (work.l <= l1 and is_min) or (work.l >= l1 and not is_min):
                self.theta = 0.0  # targeting-lambda mode
                work.h = 2.0 * (l1 - l) * work.dlds
                work.l = l + 2.0 * work.h * work.dlds
                work.target_reached = True
        if self.theta > 0.0:
            work.u = np.asarray(u) + self.theta * work.h * work.duds
        else:
            work.u = np.asarray(u).copy()
        # truncate the predictor at a u-component stop (solver_arclength:724)
        uc = stop.u_comp()
        if uc is not None:
            i, u1, is_min = uc
            if ((work.u[i] < u1 and is_min)
                    or (work.u[i] > u1 and not is_min)):
                if abs(work.duds[i]) > CONFIG_H_MIN:
                    work.h = (u1 - float(np.asarray(u)[i])) / work.duds[i]
                    work.l = l + (2.0 - self.theta) * work.h * work.dlds
                    work.u = np.asarray(u) + self.theta * work.h * work.duds
                else:
                    raise RuntimeError("INTERNAL ERROR: duds[i] is too small")
        status = Status.SUCCESS
        work.n_iteration = 0
        self.iter_jac_computed = False
        for _ in range(self.config.n_iteration_max):
            work.stats.n_iteration_total += 1
            status = self._iterate(work, u, l, args)
            if status.failure():
                break
            work.stats.record_iterations_residuals_append(
                work.err.residual_max)
            if work.err.converged():
                break
            work.n_iteration += 1
        work.stats.record_iterations_residuals_stop(work.err.converged())
        if status.success() and work.err.converged():
            self._update_tangent(work, args)
        return status

    def accept(self, work: Workspace, u, l: float, args):
        """Returns (u1, l1, rdiff) with the tangent-change rdiff
        (solver_arclength.rs:808-867)."""
        tol = self.config.tg_control_tol
        ratios = []
        den = np.abs(self.duds_prev)
        ok = den > CONFIG_H_MIN
        if np.any(ok):
            ratios.extend((np.abs(work.duds - self.duds_prev)[ok]
                           / den[ok]).tolist())
        if abs(self.dlds_prev) > CONFIG_H_MIN:
            ratios.append(abs(work.dlds - self.dlds_prev)
                          / abs(self.dlds_prev))
        if not ratios:
            rdiff = 0.0
        elif self.config.tg_control_rdiff_type == "ave":
            rdiff = sum(r / tol for r in ratios) / len(ratios)
        else:
            rdiff = max(ratios) / tol
        return work.u.copy(), work.l, rdiff

    def reject(self, work: Workspace, args):
        pass
