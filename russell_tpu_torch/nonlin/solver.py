"""Continuation solver: dispatch + fixed/list/adaptive stepping loops.

Reference contract: russell_nonlin/src/solver.rs:15,108 — constant/list
delta-lambda loop (:150-211), auto-adaptive loop (:212+) with failure/
rejection counters and the Soderlind-Wang smoothed stepsize update
(solver.rs:414).

Counterpart of ``russell_tpu.nonlin.solver``: the same loops, on the host
in f64; ``Solver(config, system, device)`` runs the system's functions,
factorizations and solves on ``device`` (the card unless the caller
names another).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

import russell_tpu_torch
from russell_tpu_torch.nonlin.config import (CONFIG_H_MIN, Config,
                                             DeltaLambda, IniDir, Method,
                                             Status, Stop)
from russell_tpu_torch.nonlin.logger import Logger
from russell_tpu_torch.nonlin.output import Output
from russell_tpu_torch.nonlin.solvers import SolverArclength, SolverNatural
from russell_tpu_torch.nonlin.stats import Workspace
from russell_tpu_torch.nonlin.system import System

__all__ = ["Solver"]


class Solver:
    """Continuation solver on ``device`` (no fallback)."""

    def __init__(self, config: Config, system: System, device="cuda"):
        config.validate()
        self.config = config
        self.ndim = system.ndim
        self.device = russell_tpu_torch.device(device)
        if config.method == Method.NATURAL:
            self.actual = SolverNatural(config, system, self.device)
        else:
            self.actual = SolverArclength(config, system, self.device)
        self.work = Workspace(config, system.ndim)
        self.log = Logger(config)
        # stepsize-adaptation memory (solver.rs)
        self._rerr_prev = 0.0
        self._rerr_anc = 0.0
        self._h_prev = 0.0
        self._h_anc = 0.0

    def stats(self):
        return self.work.stats

    def solve(self, u, l: float, direction: IniDir, stop: Stop,
              ddl: DeltaLambda, args=None,
              output: Optional[Output] = None):
        """Runs the continuation; returns (u, l, status)."""
        u = np.asarray(u, dtype=np.float64).copy()
        if len(u) != self.ndim:
            raise ValueError("u dimension must equal ndim")
        stop.validate(u, l)
        work = self.work
        work.reset_stats_and_flags(ddl.is_auto())
        work.stats.sw_total.reset()
        ddl_ini = ddl.ini(stop, l)
        self.actual.initialize(work, ddl_ini, u, l, direction, args)
        if output is not None:
            if output.execute(work, u, l, args):
                return u, l, Status.SUCCESS
        if self.config.verbose_header_footer:
            self.log.header()
        status = Status.SUCCESS

        if not ddl.is_auto():
            n_step_max = (len(ddl.list) if ddl.list
                          else self.config.n_step_max)
            for i in range(n_step_max):
                work.stats.sw_step.reset()
                self.log.step(work.h, l, False)
                work.stats.n_steps += 1
                status = self.actual.step(work, u, l, stop, args)
                if status.failure():
                    break
                work.stats.n_accepted += 1
                u, l, _ = self.actual.accept(work, u, l, args)
                if i + 1 < len(ddl.list):
                    nxt = ddl.list[i + 1]
                    if nxt <= CONFIG_H_MIN:
                        raise ValueError("requirement: ddl > 1e-10")
                    if self.config.method == Method.ARCLENGTH:
                        den = abs(work.dlds)
                        if den < CONFIG_H_MIN:
                            raise RuntimeError("dlambda/ds is too small to "
                                               "calculate the stepsize")
                        work.h = nxt / den
                    else:
                        work.h = nxt
                work.stats.h_accepted = work.h
                if not np.all(np.isfinite(u)):
                    raise RuntimeError("an element of the vector is either "
                                       "infinite or NaN")
                if output is not None:
                    if output.execute(work, u, l, args):
                        work.stats.stop_sw_step()
                        break
                work.stats.stop_sw_step()
                if work.target_reached or stop.now(i, u, l):
                    break
        else:
            for i in range(self.config.n_step_max):
                work.stats.sw_step.reset()
                self.log.step(work.h, l, False)
                work.stats.n_steps += 1
                status = self.actual.step(work, u, l, stop, args)
                if status.failure():
                    if status.try_again():
                        work.n_continued_failure += 1
                        work.follows_failure = True
                    else:
                        break
                if work.n_continued_failure >= self.config.n_cont_failure_max:
                    status = Status.CONTINUED_FAILURE
                    break
                if (work.n_continued_rejection
                        >= self.config.n_cont_rejection_max):
                    status = Status.CONTINUED_REJECTION
                    break
                if status.failure():
                    work.stats.n_rejected += 1
                    work.follows_rejection = True
                    self.actual.reject(work, args)
                    work.h *= self.config.m_failure
                else:
                    work.stats.n_accepted += 1
                    u, l, rdiff = self.actual.accept(work, u, l, args)
                    if not np.all(np.isfinite(u)):
                        raise RuntimeError("an element of the vector is "
                                           "either infinite or NaN")
                    if work.target_reached:
                        break
                    h_est = self._adapt_stepsize(rdiff)
                    if work.follows_failure or work.follows_rejection:
                        h_est = min(h_est, work.h)
                    work.h = h_est
                    work.stats.h_accepted = h_est
                    work.n_continued_failure = 0
                    work.n_continued_rejection = 0
                    work.follows_failure = False
                    work.follows_rejection = False
                    if output is not None:
                        if output.execute(work, u, l, args):
                            work.stats.stop_sw_step()
                            break
                    work.stats.stop_sw_step()
                    if stop.now(i, u, l):
                        break
                if work.h < CONFIG_H_MIN:
                    status = Status.SMALL_STEPSIZE
                    break

        work.stats.stop_sw_total()
        if self.config.verbose_header_footer:
            self.log.step(work.h, l, True)
            self.log.footer(work.stats, status)
        return u, l, status

    def _adapt_stepsize(self, rdiff: float) -> float:
        """Soderlind-Wang smoothed stepsize update (solver.rs:330-416)."""
        cfg = self.config
        if cfg.nr_control_enabled:
            nn = max(1.0, float(self.work.n_iteration))
            ksi = (cfg.nr_control_n_opt / nn) ** cfg.nr_control_beta
        else:
            ksi = 1.0
        assert rdiff >= 0.0
        if rdiff < cfg.tg_control_rdiff_min:
            rdiff = 0.0
        if cfg.tg_control_enabled:
            if rdiff == 0.0:
                rho = cfg.tg_control_rho_for_tiny_rdiff
            elif cfg.tg_control_pid_vcc:
                KP, KI, KD = 0.075, 0.175, 0.01
                p = d = 1.0
                i = 1.0 / rdiff
                if self.work.stats.n_accepted > 1:
                    p = self._rerr_prev / rdiff
                if self.work.stats.n_accepted > 2 and self._rerr_anc > 0.0:
                    d = self._rerr_prev ** 2 / (rdiff * self._rerr_anc)
                rho = p ** KP * i ** KI * d ** KD
            else:
                rho = (1.0 / rdiff) ** (1.0 / 2.0)
        else:
            rho = 1.0
        self._rerr_anc = self._rerr_prev
        self._rerr_prev = rdiff
        self._h_anc = self._h_prev
        self._h_prev = self.work.h
        m = 1.0 + math.atan(ksi * rho - 1.0)
        return self.work.h * m
