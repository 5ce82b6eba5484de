"""Explicit Runge-Kutta steppers, in PyTorch (the 13 ERK methods of the
reference).

Counterpart of ``russell_tpu.ode.erk`` (reference behavior:
russell_ode/src/explicit_runge_kutta.rs). The stage evaluations, the
update w, the embedded error sums and the stiffness-ratio sums run as
torch ops on the state's device, with the reference package's operations
in its order (``vi + (h·a)·k_j`` left to right, zero coefficients
skipped); the scalar tail of the error norm and the controller
(Lund-stabilized stepsize update, dopri5.f lines 463-467) run on the host
in f64, so the accept/reject counters are the reference's. A step copies
one small vector to the host (the error sums, and the stiffness sums when
detection is enabled), and none for a method without an error estimator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.ode import constants as C
from russell_tpu_torch.ode.enums import Method
from russell_tpu_torch.ode.erk_dense_out import ErkDenseOut
from russell_tpu_torch.ode.detect_stiffness import detect_stiffness

__all__ = ["ExplicitRungeKutta"]


class ExplicitRungeKutta:
    """One stepper for every explicit RK tableau (explicit_runge_kutta.rs:23)."""

    def __init__(self, params, system):
        method = params.method
        info = method.information()
        if info.implicit or not info.multiple_stages:
            raise ValueError(f"cannot use {method} with ExplicitRungeKutta")
        self.params = params
        self.system = system
        self.info = info
        A, B, Cc, E = C.tableau(method)
        self.A, self.B, self.Cc = A.tolist(), B.tolist(), Cc.tolist()
        self.E = None if E is None else E.tolist()
        self.nstage = len(self.B)
        self.lund_factor = (1.0 / (info.order_of_estimator + 1)
                            - params.erk.lund_beta * params.erk.lund_m)
        self.d_min = 1.0 / params.step.m_min
        self.d_max = 1.0 / params.step.m_max
        self.k = None          # list of nstage stage derivatives (device)
        self.w = None          # updated y (device)
        self.dense_out = None
        self._f = system.function
        self._stiff_num = 0.0
        self._stiff_den = 0.0

    # -- the step's device work ----------------------------------------------

    def _stages(self, x, y, h, k0, args):
        """(ks, vs, w): the stage derivatives, the stage states and the
        update."""
        f, A, B, Cc = self._f, self.A, self.B, self.Cc
        ks = [k0]
        vs = [y]
        for i in range(1, self.nstage):
            vi = y
            for j in range(i):
                a = A[i][j]
                if a != 0.0:
                    vi = vi + (h * a) * ks[j]
            ks.append(f(x + h * Cc[i], vi, args))
            vs.append(vi)
        w = y
        for i in range(self.nstage):
            if B[i] != 0.0:
                w = w + (B[i] * h) * ks[i]
        return ks, vs, w

    def _error_sums(self, y, h, w, ks, vs):
        """The device sums the error norm and the stiffness ratio need, as
        one vector: DoPri8 (err_3, err_5), the others (sum ratio²,); then,
        when stiffness detection is on, DoPri5's (num, den) or DoPri8's
        den."""
        B, E = self.B, self.E
        method = self.params.method
        sk = (self.params.tol.abs
              + self.params.tol.rel * torch.maximum(torch.abs(y),
                                                    torch.abs(w)))
        if method == Method.DOPRI8:
            # 8(5,3) double error estimate (dop853.f; HW-I Eq. 10.17)
            err_a = torch.zeros_like(y)
            err_b = torch.zeros_like(y)
            for i in range(self.nstage):
                if B[i] != 0.0:
                    err_a = err_a + B[i] * ks[i]
                if E[i] != 0.0:
                    err_b = err_b + E[i] * ks[i]
            err_a = (err_a - C.DOPRI8_BHH1 * ks[0] - C.DOPRI8_BHH2 * ks[8]
                     - C.DOPRI8_BHH3 * ks[11])
            ra, rb = err_a / sk, err_b / sk
            sums = [torch.sum(ra * ra), torch.sum(rb * rb)]
        else:
            err_m = torch.zeros_like(y)
            for i in range(self.nstage):
                if E[i] != 0.0:
                    err_m = err_m + (E[i] * h) * ks[i]
            ratio = err_m / sk
            sums = [torch.sum(ratio * ratio)]
        # stiffness-ratio quantities (HW-II Eq. 2.26, page 22)
        if self.params.stiffness.enabled:
            if method == Method.DOPRI5:
                dk, dv = ks[6] - ks[5], vs[6] - vs[5]
                sums += [torch.sum(dk * dk), torch.sum(dv * dv)]
            elif method == Method.DOPRI8:
                # num needs f(x+h, w): accept computes it
                dv = w - vs[11]
                sums.append(torch.sum(dv * dv))
        return torch.stack(sums).tolist()

    def _rel_error(self, h, sums):
        dim = float(self.system.ndim)
        if self.params.method == Method.DOPRI8:
            err_3, err_5 = sums[0], sums[1]
            den = err_5 + 0.01 * err_3
            if den <= 0.0:
                den = 1.0
            return abs(h) * err_5 * math.sqrt(1.0 / (dim * den))
        return max(math.sqrt(sums[0] / dim), 1.0e-10)

    # -- OdeSolverTrait surface ----------------------------------------------

    def enable_dense_output(self):
        self.dense_out = ErkDenseOut(self.params.method, self.system.ndim,
                                     self.system)

    def step(self, work, x, y, h, args):
        if ((work.stats.n_accepted == 0 or not self.info.first_step_same_as_last)
                and not work.follows_reject_step) or self.k is None:
            work.stats.n_function += 1
            k0 = self._f(x, y, args)
        else:
            k0 = self.k[0]
        work.stats.n_function += self.nstage - 1
        ks, vs, w = self._stages(x, y, h, k0, args)
        self.k = ks
        self.w = w
        if not self.info.embedded:
            return
        sums = self._error_sums(y, h, w, ks, vs)
        work.rel_error = self._rel_error(h, sums)
        if self.params.stiffness.enabled:
            if self.params.method == Method.DOPRI5:
                self._stiff_num, self._stiff_den = sums[1], sums[2]
            elif self.params.method == Method.DOPRI8:
                self._stiff_den = sums[2]

    def accept(self, work, x, y, h, args):
        """Returns (x_new, y_new); updates work counters/stepsize."""
        if self.dense_out is not None:
            work.stats.n_function += self.dense_out.update(
                x, y, h, self.w, self.k, args)
        x_new = x + h
        y_new = self.w
        if self.info.first_step_same_as_last:
            # a new list: k[0] is the last stage's tensor, which no later
            # step writes (each step makes new stage tensors)
            self.k = [self.k[self.nstage - 1]] + self.k[1:]
        if not self.info.embedded:
            return x_new, y_new

        # stepsize estimate (dopri5.f lines 463-467)
        fac = work.rel_error ** self.lund_factor
        if self.params.erk.lund_beta > 0.0 and work.rel_error_prev > 0.0:
            fac = fac / work.rel_error_prev ** self.params.erk.lund_beta
        fac = max(self.d_max, min(self.d_min, fac / self.params.step.m_safety))
        work.h_new = h / fac

        # stiffness detection
        if self.params.stiffness.enabled:
            if self.params.method == Method.DOPRI5:
                num, den = self._stiff_num, self._stiff_den
                if den > np.finfo(float).eps:
                    work.stiff_h_times_rho = h * math.sqrt(num / den)
                detect_stiffness(work, x_new - h, self.params)
            elif self.params.method == Method.DOPRI8:
                work.stats.n_function += 1
                dk = self._f(x_new, y_new, args) - self.k[11]
                num = float(torch.sum(dk * dk))
                den = self._stiff_den
                if den > np.finfo(float).eps:
                    work.stiff_h_times_rho = h * math.sqrt(num / den)
                detect_stiffness(work, x_new - h, self.params)
        return x_new, y_new

    def reject(self, work, h):
        d = work.rel_error ** self.lund_factor / self.params.step.m_safety
        work.h_new = h / min(self.d_min, d)

    def dense_output(self, x_out, x, y, h):
        if self.dense_out is None:
            raise RuntimeError("dense output was not enabled")
        return self.dense_out.calculate(x_out, x, h)

    def update_params(self, params):
        self.params = params
