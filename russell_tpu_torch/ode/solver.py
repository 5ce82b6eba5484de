"""OdeSolver: the host stepping loops, in PyTorch.

Counterpart of ``russell_tpu.ode.solver`` (reference behavior:
russell_ode/src/ode_solver.rs:177-380 — stepsize initialization,
error-controlled accept/reject, divergence backoff (:300-306), the
``vec_all_finite`` anomaly check). The per-step work runs on the device
the solver was given; this module is the host-side control loop in f64.

Every method of ``Method`` runs, with an ``Output`` (step and dense
output, callbacks, JSON files, stiffness recording). ``fused=True`` (Radau5
or an embedded explicit Runge-Kutta method) runs the whole integration on
the device (``radau5_fused.py``, ``erk_fused.py``): on the card one step
attempt is captured as a CUDA graph and replayed, its control flow on the
device; on the CPU the same step runs eagerly. ``solve_batch`` runs B
initial values as lanes of one fused integration.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

import russell_tpu_torch
from russell_tpu_torch.ode.constants import N_EQUAL_STEPS
from russell_tpu_torch.ode.enums import Method
from russell_tpu_torch.ode.erk import ExplicitRungeKutta
from russell_tpu_torch.ode.euler import EulerForward, EulerBackward
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
        if system.mass is not None and params.method != Method.RADAU5:
            raise ValueError("the mass matrix requires the Radau5 method")
        self.params = params
        self.system = system
        self.ndim = system.ndim
        self.device = russell_tpu_torch.device(device)
        if params.method == Method.RADAU5:
            self.actual = Radau5(params, system, self.device)
        elif params.method == Method.BW_EULER:
            self.actual = EulerBackward(params, system)
        elif params.method == Method.FW_EULER:
            self.actual = EulerForward(system)
        else:
            self.actual = ExplicitRungeKutta(params, system)
        self.work = Workspace(params.method)
        # fused integrations by (dense stations, lanes): each keeps its
        # captured graph for the next solve
        self._fused = {}

    def stats(self):
        return self.work.stats

    def update_params(self, params: Params):
        params.validate()
        if params.method != self.params.method:
            raise ValueError("update_params must not change the method")
        self.params = params
        self.actual.update_params(params)

    def solve(self, y0, x0: float, x1: float, h_equal: Optional[float] = None,
              args=None, output=None, fused: bool = False):
        """Integrate from (x0, y0) to x1; returns the final y (f64 tensor
        on the solver's device). ``output`` (an ``Output``) records or
        streams the accepted steps and dense stations.

        ``fused=True`` (Radau5 or an embedded ERK method, no ``h_equal``,
        ``args=None``) runs the whole variable-step integration on the
        device; an Output may then have dense stations only (its callbacks
        and files are played back after the integration)."""
        if fused:
            return self._solve_fused(y0, x0, x1, args, output, h_equal)
        y = self._y_on_device(y0)
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

        if output is not None:
            output.initialize(x0, x1, self.params.stiffness.save_results)
            if output.with_dense_output():
                self.actual.enable_dense_output()
            if output.execute(work, h, x, y, self.actual, args):
                return y

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
                if output is not None:
                    if output.execute(work, h, x, y, self.actual, args):
                        work.stats.stop_sw_step()
                        work.stats.stop_sw_total()
                        return y
                work.stats.stop_sw_step()
            if output is not None:
                output.last(work, h, x, y, args)
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
                if output is not None:
                    if output.execute(work, h, x, y, self.actual, args):
                        work.stats.stop_sw_step()
                        work.stats.stop_sw_total()
                        return y
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

        if output is not None:
            output.last(work, h, x, y, args)
        work.stats.stop_sw_total()
        if not success:
            raise RuntimeError(
                "variable stepping did not converge with n_step_max steps")
        return y

    def _y_on_device(self, y0):
        if isinstance(y0, torch.Tensor):
            return y0.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(y0, dtype=np.float64),
                               device=self.device)

    def _build_fused(self, lanes=1, dense_x=None):
        """The fused whole-integration solver of the current method:
        Radau5 (radau5_fused.py) or an embedded ERK (erk_fused.py)."""
        if self.params.method == Method.RADAU5:
            from russell_tpu_torch.ode.radau5_fused import FusedRadau5
            return FusedRadau5(self.actual, self.params, lanes, dense_x)
        if dense_x is not None and self.params.method not in (
                Method.DOPRI5, Method.DOPRI8):
            raise ValueError("fused dense output requires Radau5, DoPri5 "
                             "or DoPri8")
        if (isinstance(self.actual, ExplicitRungeKutta)
                and self.actual.info.embedded):
            from russell_tpu_torch.ode.erk_fused import FusedErk
            return FusedErk(self.actual, self.params, self.device, lanes,
                            dense_x)
        raise ValueError("fused solve requires Radau5 or an embedded "
                         "explicit Runge-Kutta method")

    def _fused_for(self, lanes, dense_x=None):
        key = (lanes, None if dense_x is None else tuple(dense_x.tolist()))
        fn = self._fused.get(key)
        if fn is None:
            fn = self._fused[key] = self._build_fused(lanes, dense_x)
        return fn

    def _solve_fused(self, y0, x0, x1, args, output, h_equal):
        if h_equal is not None:
            raise ValueError("fused solve does not support h_equal")
        if args is not None:
            raise ValueError("fused solve requires args=None (close over "
                             "static data in the system functions)")
        dense_x = None
        if output is not None:
            # the integration runs on the device: only dense stations ride
            # along; step output and callbacks need the host-stepped path
            if (output.step_callback is not None
                    or output.step_file_key is not None
                    or output.step_recording
                    or self.params.stiffness.save_results):
                raise ValueError(
                    "fused solve supports dense output only (no step "
                    "recording/callbacks/stiffness); use fused=False")
            output.initialize(x0, x1, False)
            if not output.with_dense_output():
                raise ValueError("the attached Output has no dense output "
                                 "configured; use fused=False")
            dense_x = np.asarray(output.dense_x(), dtype=np.float64)
        y = self._y_on_device(y0)
        if y.shape[0] != self.ndim:
            raise ValueError("y0 dimension must equal ndim")
        if x1 <= x0:
            raise ValueError("x1 must be greater than x0")
        fn = self._fused_for(1, dense_x)
        h0 = min(self.params.step.h_ini, x1 - x0)
        ys, st = fn.solve(x0, y[None], x1, h0)
        host = {k: v.tolist()[0] for k, v in st.items()
                if k not in ("dense_y", "dense_h")}
        stats = self.work.stats
        for k in ("n_function", "n_jacobian", "n_factor", "n_lin_sol",
                  "n_steps", "n_accepted", "n_rejected", "n_iterations",
                  "n_iterations_max"):
            if k in host:
                setattr(stats, k, host[k])
        stats.h_accepted = host["h_accepted"]
        status = host["status"]
        if status == 2:
            raise RuntimeError("the stepsize becomes too small")
        if status == 3:
            raise RuntimeError(
                "Newton-Raphson method did not complete successfully")
        if status != 1:
            raise RuntimeError(
                "variable stepping did not converge with n_step_max steps")
        y = ys[0]
        self._check_finite(y)
        if output is not None:
            self._playback_dense(output, st, host, y)
        return y

    def _playback_dense(self, output, st, host, y_final):
        """Hand the device-filled stations to the Output's callback, file
        and recording hooks in station order (the streaming order of
        output.rs:269-285; a callback that returns True stops the
        playback: the integration has already finished)."""
        from russell_tpu_torch.ode.output import OutCount, OutData
        dense = st["dense_y"][0].to("cpu").numpy().copy()
        hh = st["dense_h"][0].to("cpu").numpy().copy()
        xs = output.dense_x()
        n = len(xs)
        # last station: the final y at the last accepted h (output.rs last())
        dense[n - 1] = y_final.to("cpu").numpy()
        hh[n - 1] = host["h_prev"]
        stats = self.work.stats
        stopped = False
        for i in range(n):
            if output.dense_callback is not None:
                if output.dense_callback(stats, hh[i], xs[i], dense[i],
                                         None):
                    stopped = True
                    break
            if output.dense_file_key is not None:
                OutData(hh[i], xs[i], dense[i]).write_json(
                    f"{output.dense_file_key}_"
                    f"{output.dense_file_count}.json")
                output.dense_file_count += 1
            if output.dense_recording:
                for m, ym in output._dense_y.items():
                    ym[i] = float(dense[i][m])
        output.dense_index = n - 1
        if output.dense_file_key is not None and not stopped:
            OutCount(output.dense_file_count).write_json(
                f"{output.dense_file_key}_count.json")

    def solve_batch(self, y0_batch, x0, x1, h0: Optional[float] = None):
        """Solve the same system from B initial values at once: lanes of
        one fused integration (the reference package vmaps its fused
        loop), each with its own stepsize and Newton path. Radau5 lanes
        factorize through the plan's route, whichever genie it is, in one
        batched numeric phase over the one plan.

        Returns (y (B, ndim), stats): a dict of (B,) tensors with
        ``status`` (1 for a lane that reached x1) and the counters. On the
        card, raises ValueError before the step attempt's capture where
        the memory its warm-up reserved would not fit on the card
        (``_device_loop.capture_refusal``): the factorize body's
        temporaries grow with the lanes."""
        y0s = self._y_on_device(y0_batch)
        if y0s.dim() != 2 or y0s.shape[1] != self.ndim:
            raise ValueError("y0_batch must be (B, ndim)")
        if x1 <= x0:
            raise ValueError("x1 must be greater than x0")
        fn = self._fused_for(y0s.shape[0])
        h = h0 if h0 is not None else min(self.params.step.h_ini, x1 - x0)
        return fn.solve(x0, y0s, x1, h)

    @staticmethod
    def _check_finite(y):
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("an element of the vector is either infinite "
                               "or NaN")
