"""OdeSolver: the host stepping loops, in PyTorch.

Counterpart of ``russell_tpu.ode.solver`` (reference behavior:
russell_ode/src/ode_solver.rs:177-380 — stepsize initialization,
error-controlled accept/reject, divergence backoff (:300-306), the
``vec_all_finite`` anomaly check). The per-step work runs on the device
the solver was given; this module is the host-side control loop in f64.

This slice ports Radau5 without an Output; the other methods, dense
output and the fused whole-integration loop are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.ode.constants import N_EQUAL_STEPS
from russell_tpu_torch.ode.enums import Method
from russell_tpu_torch.ode.params import Params
from russell_tpu_torch.ode.radau5 import Radau5
from russell_tpu_torch.ode.stats import Workspace
from russell_tpu_torch.ode.system import System

__all__ = ["OdeSolver"]

EPS = 2.220446049250313e-16


class OdeSolver:
    """Error-controlled ODE/DAE solver (ode_solver.rs:120) on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, params: Params, system: System, device="cuda"):
        params.validate()
        if params.method != Method.RADAU5:
            raise NotImplementedError(
                f"method {params.method.name} is not ported yet: the port "
                "has Radau5 only (ROADMAP.md)")
        self.params = params
        self.system = system
        self.ndim = system.ndim
        self.device = russell_tpu_torch.device(device)
        self.actual = Radau5(params, system, self.device)
        self.work = Workspace(params.method)

    def stats(self):
        return self.work.stats

    def solve(self, y0, x0: float, x1: float, h_equal: Optional[float] = None,
              args=None, output=None, fused: bool = False):
        """Integrate from (x0, y0) to x1; returns the final y (f64 tensor
        on the solver's device)."""
        if fused:
            raise NotImplementedError("fused=True (the whole-integration "
                                      "loop) is not ported yet (ROADMAP.md)")
        if output is not None:
            raise NotImplementedError("Output is not ported yet "
                                      "(ROADMAP.md)")
        y = torch.as_tensor(np.asarray(y0, dtype=np.float64),
                            device=self.device)
        if y.shape[0] != self.ndim:
            raise ValueError("y0 dimension must equal ndim")
        if x1 <= x0:
            raise ValueError("x1 must be greater than x0")
        info = self.params.method.information()

        # initial stepsize (ode_solver.rs:196-216)
        if h_equal is not None:
            if h_equal < 10.0 * EPS:
                raise ValueError("h_equal must be >= 10.0 * EPSILON")
            nstep = math.ceil((x1 - x0) / h_equal)
            h = (x1 - x0) / nstep
            equal_stepping = True
        elif info.embedded:
            h = min(self.params.step.h_ini, x1 - x0)
            equal_stepping = False
        else:
            h = (x1 - x0) / N_EQUAL_STEPS
            equal_stepping = True
        assert h > 0.0

        work = self.work
        work.reset(h, self.params.step.rel_error_prev_min)
        work.stats.sw_total.reset()
        x = x0

        # equal-stepping loop (ode_solver.rs:239-271)
        if equal_stepping:
            nstep = math.ceil((x1 - x) / h)
            for _ in range(nstep):
                work.stats.sw_step.reset()
                work.stats.n_steps += 1
                self.actual.step(work, x, y, h, args)
                work.stats.n_accepted += 1  # must come after step
                x, y = self.actual.accept(work, x, y, h, args)
                self._check_finite(y)
                work.stats.stop_sw_step()
            work.stats.stop_sw_total()
            return y

        # variable-stepping loop (ode_solver.rs:278-366)
        success = False
        last_step = False
        for _ in range(self.params.step.n_step_max):
            work.stats.sw_step.reset()
            dx = x1 - x
            if dx <= 10.0 * EPS:
                success = True
                work.stats.stop_sw_step()
                break
            h = min(work.h_new, dx)
            if h <= 10.0 * EPS:
                raise RuntimeError("the stepsize becomes too small")

            work.stats.n_steps += 1
            self.actual.step(work, x, y, h, args)

            if work.iterations_diverging:
                work.iterations_diverging = False
                work.follows_reject_step = True
                last_step = False
                work.h_new = h * work.h_multiplier_diverging
                continue

            if work.rel_error < 1.0:
                # accept
                work.stats.n_accepted += 1
                x, y = self.actual.accept(work, x, y, h, args)
                self._check_finite(y)
                if work.follows_reject_step:
                    work.h_new = min(work.h_new, h)
                work.follows_reject_step = False
                work.h_prev = h
                work.rel_error_prev = max(self.params.step.rel_error_prev_min,
                                          work.rel_error)
                work.stats.h_accepted = work.h_new
                if last_step:
                    success = True
                    work.stats.stop_sw_step()
                    break
                if x + work.h_new >= x1:
                    last_step = True
            else:
                # reject
                if work.stats.n_accepted > 0:
                    work.stats.n_rejected += 1
                work.follows_reject_step = True
                last_step = False
                if (work.stats.n_accepted == 0
                        and self.params.step.m_first_reject > 0.0):
                    work.h_new = h * self.params.step.m_first_reject
                else:
                    self.actual.reject(work, h)
            work.stats.stop_sw_step()

        work.stats.stop_sw_total()
        if not success:
            raise RuntimeError(
                "variable stepping did not converge with n_step_max steps")
        return y

    @staticmethod
    def _check_finite(y):
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("an element of the vector is either infinite "
                               "or NaN")
