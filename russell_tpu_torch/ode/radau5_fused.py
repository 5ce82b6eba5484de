"""The whole Radau5 integration on the device, in PyTorch.

Counterpart of ``russell_tpu.ode.radau5_fused`` (``build_fused_solver``):
the variable-step loop of ode_solver.rs:278-366 with Radau5's step, accept
and reject (the simplified Newton iteration with its divergence
prediction, the Gustafsson controller, the Jacobian and factorization
reuse policy and the statistics counters) as one step attempt over state
that lives on the device, run by ``_device_loop.DeviceLoop``: on the card
a CUDA graph, captured once and replayed, whose IF nodes skip what the
reference's ``lax.cond`` and ``lax.while_loop`` skip (the first f, the
Jacobian, the factorize pair, each Newton iteration, the second error
estimate, the whole attempt once the integration is done); the host reads
only a done flag. The arithmetic and its order are the host path's
(``radau5.py`` and ``solver.py``), so the counters are the host path's.

The step runs over a leading lane dimension B (``solve_batch``; a single
solve is B = 1). Each lane keeps its own controller and stops changing
once it is done; the lanes whose policy asks for a factorization are
factored together, in one batched numeric phase of the plan's route
(every genie: DENSE, BANDED, SPLU, GRIDMF, GENMF), and ``torch.where``
commits only theirs. One lane's factor pair is the one the last factorize
body made (the reference package refactorizes at the kept step size every
step instead, which gives the same numbers).

Not carried over: the chunked device calls and their environment
variables (a workaround for the TPU worker's time limit) and mixed32.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.ode._device_loop import (DeviceLoop, check_capturable,
                                                when)
from russell_tpu_torch.ode._lanes import (Lanes, lane_div, lane_pow,
                                          lane_sum, put, tree_commit)
from russell_tpu_torch.ode.constants import radau5_constants
from russell_tpu_torch.sparse import factor as _factor

__all__ = ["FusedRadau5"]

EPS = 2.220446049250313e-16
_R5 = radau5_constants()
_COUNTERS = ("n_steps", "n_accepted", "n_rejected", "n_function",
             "n_jacobian", "n_factor", "n_lin_sol", "n_iterations",
             "n_iterations_max")


class FusedRadau5:
    """One fused Radau5 integration of ``lanes`` lanes for a Radau5
    stepper (its plan, mass and Jacobian), with dense stations
    ``dense_x`` (sorted, x0 and x1 included) or none. ``solve`` may be
    called again with other initial values: the captured graph is kept."""

    def __init__(self, stepper, params, lanes: int = 1, dense_x=None):
        system = stepper.system
        self.plan = stepper.plan
        self.device = dev = stepper.device
        self.B = B = int(lanes)
        self.ndim = n = system.ndim
        self.lanes = Lanes(system, stepper._jac_fn, B)
        self.has_mass = stepper._has_mass
        self.mass_vv = stepper._mass_vv_d
        self.mass_ii = stepper._mass_ii_d
        self.mass_jj = stepper._mass_jj_d
        self.jac_extra = n if stepper._numerical else 0
        p = params
        self.abs_tol, self.rel_tol = p.tol.abs, p.tol.rel
        self.tol_newton = p.tol.newton
        self.nit = p.newton.n_iteration_max
        self.m_min, self.m_max = p.step.m_min, p.step.m_max
        self.m_safety = p.step.m_safety
        self.m_first_reject = p.step.m_first_reject
        self.rel_error_prev_min = p.step.rel_error_prev_min
        self.n_step_max = p.step.n_step_max
        self.theta_max = p.radau5.theta_max
        self.c1h, self.c2h = p.radau5.c1h, p.radau5.c2h
        self.use_pred = p.radau5.use_pred_control
        self.zero_trial = p.radau5.zero_trial

        f64 = dict(dtype=torch.float64, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        b1 = dict(dtype=torch.bool, device=dev)
        nnz = len(self.plan.rows) - len(stepper._mass_vv)
        s = self.s = {}
        for k in ("x", "x1", "h_new", "h_prev", "rel_error",
                  "rel_error_prev", "eta", "h_fact"):
            s[k] = torch.zeros(B, **f64)
        for k in ("follows_reject", "last_step", "jac_computed",
                  "reuse_jac", "reuse_fact"):
            s[k] = torch.zeros(B, **b1)
        for k in ("status", "iter_count") + _COUNTERS:
            s[k] = torch.zeros(B, **i64)
        s["y"] = torch.zeros(B, n, **f64)
        s["k_acc"] = torch.zeros(B, n, **f64)
        s["scaling"] = torch.ones(B, n, **f64)
        s["yc"] = torch.zeros(B, 3, n, **f64)
        s["jv"] = torch.zeros(B, nnz, **f64)
        self.dense_xs = None
        if dense_x is not None:
            xs = np.asarray(dense_x, dtype=np.float64)
            if len(xs) < 2:
                raise ValueError("dense_x must include x0 and x1")
            self.dense_xs = torch.as_tensor(xs, device=dev)
            # the last station is the final y, which the solver fills in
            self.dense_ok = torch.arange(len(xs), device=dev) < len(xs) - 1
            s["dense_y"] = torch.zeros(B, len(xs), n, **f64)
            s["dense_h"] = torch.zeros(B, len(xs), **f64)
        # scratch of one attempt (rewritten before it is read)
        self.kf = torch.zeros(B, n, **f64)
        self.w = torch.zeros(B, 3, n, **f64)
        self.z = torch.zeros(B, 3, n, **f64)
        self.rel = torch.zeros(B, **f64)
        nw = self.nw = {}
        for k in ("theta", "thq_old", "eta", "ldw_old", "h_mult"):
            nw[k] = torch.zeros(B, **f64)
        for k in ("div", "conv", "done"):
            nw[k] = torch.zeros(B, **b1)
        nw["newt"] = torch.zeros(B, **i64)
        self.done = torch.zeros((), **b1)
        self.fac = None
        self.loop = DeviceLoop(self._attempt, list(s.values()), self.done,
                               dev, before_capture=self._drop_pair)
        self._prepared = False

    # -- lane arithmetic (radau5.py's, over a leading lane dimension) -------

    @staticmethod
    def _shifts(h):
        """(alpha, beta, gamma) / h, each (B, 1)."""
        return tuple(lane_div(_R5[k], h)[:, None]
                     for k in ("ALPHA", "BETA", "GAMMA"))

    def _mass_mat_vec(self, w):
        out = torch.zeros_like(w)
        return out.index_add_(1, self.mass_ii,
                              self.mass_vv * w[:, self.mass_jj])

    def _factor_pair(self, jv, h):
        """The real and complex Newton matrices' entries at step h (B,)."""
        alpha, beta, gamma = self._shifts(h)
        mass = self.mass_vv[None, :]
        data_r = torch.cat([-jv, gamma * mass], dim=1)
        # (alpha + i beta) * mass, as the host path's complex product
        # gives it: (alpha m - beta 0, alpha 0 + beta m)
        data_c = torch.cat([-jv.to(torch.complex128),
                            torch.complex(alpha * mass, beta * mass)], dim=1)
        if self.B == 1:
            return _factor.numeric_factorize_pair(self.plan, data_r[0],
                                                  data_c[0])
        return _factor.numeric_factorize_pair(self.plan, data_r, data_c)

    def _solve(self, fac, b):
        if self.B == 1:
            return _factor.factor_solve(self.plan, fac, b[0],
                                        refine_steps=0)[None]
        return _factor.factor_solve(self.plan, fac, b, refine_steps=0)

    def _solve_pair(self, b_r, b_c):
        fr, fc = self.fac
        if self.B == 1:
            xr, xc = _factor.factor_solve_pair(self.plan, fr, fc, b_r[0],
                                               b_c[0], refine_steps=0)
            return xr[None], xc[None]
        return _factor.factor_solve_pair(self.plan, fr, fc, b_r, b_c,
                                         refine_steps=0)

    def _newton_once(self, x, y, h, w, z, scaling):
        T, TI, C = _R5["T"].tolist(), _R5["TI"].tolist(), _R5["C"].tolist()
        alpha, beta, gamma = self._shifts(h)
        F = self.lanes.function
        k0 = F(x + C[0] * h, y + z[:, 0])
        k1 = F(x + C[1] * h, y + z[:, 1])
        k2 = F(x + C[2] * h, y + z[:, 2])
        if self.has_mass:
            l0, l1, l2 = (self._mass_mat_vec(w[:, 0]),
                          self._mass_mat_vec(w[:, 1]),
                          self._mass_mat_vec(w[:, 2]))
        else:
            l0, l1, l2 = w[:, 0], w[:, 1], w[:, 2]
        r0 = TI[0][0] * k0 + TI[0][1] * k1 + TI[0][2] * k2 - gamma * l0
        r1 = (TI[1][0] * k0 + TI[1][1] * k1 + TI[1][2] * k2
              - alpha * l1 + beta * l2)
        r2 = (TI[2][0] * k0 + TI[2][1] * k1 + TI[2][2] * k2
              - beta * l1 - alpha * l2)
        dw0, dw12 = self._solve_pair(r0, torch.complex(r1, r2))
        w0 = w[:, 0] + dw0
        w1 = w[:, 1] + dw12.real
        w2 = w[:, 2] + dw12.imag
        wn = torch.stack([w0, w1, w2], dim=1)
        zn = torch.stack([
            T[0][0] * w0 + T[0][1] * w1 + T[0][2] * w2,
            T[1][0] * w0 + T[1][1] * w1 + T[1][2] * w2,
            T[2][0] * w0 + T[2][1] * w1 + T[2][2] * w2], dim=1)
        ldw = torch.sqrt((lane_sum((dw0 / scaling) ** 2)
                          + lane_sum((dw12.real / scaling) ** 2)
                          + lane_sum((dw12.imag / scaling) ** 2))
                         / (3.0 * self.ndim))
        return wn, zn, ldw

    def _trial(self, h, h_prev, yc):
        TI = _R5["TI"].tolist()
        MU1, MU2, MU3, MU4 = _R5["MU1"], _R5["MU2"], _R5["MU3"], _R5["MU4"]
        c3q = (h / h_prev)[:, None]
        c1q = MU1 * c3q
        c2q = MU2 * c3q

        def poly(cq):
            return cq * (yc[:, 0] + (cq - MU4)
                         * (yc[:, 1] + (cq - MU3) * yc[:, 2]))

        z0, z1, z2 = poly(c1q), poly(c2q), poly(c3q)
        z = torch.stack([z0, z1, z2], dim=1)
        w = torch.stack([
            TI[0][0] * z0 + TI[0][1] * z1 + TI[0][2] * z2,
            TI[1][0] * z0 + TI[1][1] * z1 + TI[1][2] * z2,
            TI[2][0] * z0 + TI[2][1] * z1 + TI[2][2] * z2], dim=1)
        return z, w

    def _rel_error(self, err, scaling):
        return torch.clamp_min(torch.sqrt(
            lane_sum((err / scaling) ** 2) / self.ndim), 1e-10)

    def _step_divisor(self, rel, n_it):
        """radau5.f's step-size quotient (radau5.rs:609-625)."""
        nit = self.nit
        num = self.m_safety * (1 + 2 * nit)
        den = (n_it + 2 * nit).to(torch.float64)
        fac = torch.clamp_max(lane_div(num, den), self.m_safety)
        return torch.clamp(lane_pow(rel, 0.25) / fac, self.m_min, self.m_max)

    # -- the step attempt ---------------------------------------------------

    def _attempt(self):
        s = self.s
        act = (s["status"] == 0) & (s["iter_count"] < self.n_step_max)
        when(act.any(), lambda: self._attempt_body(act))
        torch.logical_not(((s["status"] == 0)
                           & (s["iter_count"] < self.n_step_max)).any(),
                          out=self.done)

    def _attempt_body(self, act):
        s = self.s
        s["iter_count"].add_(act.long())
        dx = s["x1"] - s["x"]
        done_conv = dx <= 10.0 * EPS
        h = torch.minimum(s["h_new"], dx)
        too_small = (h <= 10.0 * EPS) & ~done_conv
        fin = act & (done_conv | too_small)
        put(s["status"], fin, torch.where(done_conv, 1, 2))
        go = act & ~fin
        when(go.any(), lambda: self._step(go, h))

    def _step(self, go, h):
        s, nw = self.s, self.nw
        F = self.lanes.function
        s["n_steps"].add_(go.long())
        first = s["n_accepted"] == 0
        # initialize at the first accepted phase (radau5.rs:186)
        scaling = torch.where(
            first[:, None], self.abs_tol + self.rel_tol * torch.abs(s["y"]),
            s["scaling"])
        need_f = go & first
        when(need_f.any(), lambda: self.kf.copy_(F(s["x"], s["y"])))
        k_acc = torch.where(need_f[:, None], self.kf, s["k_acc"])
        nfcn = s["n_function"] + first.long()

        # Jacobian and factorization, with the reuse policy
        need_j = go & ~(s["reuse_fact"] | s["reuse_jac"] | s["jac_computed"])
        when(need_j.any(), lambda: put(
            s["jv"], need_j, self.lanes.jacobian(s["x"], s["y"])))
        njac = need_j.long()
        need_fac = go & ~s["reuse_fact"]
        put(s["h_fact"], go, torch.where(s["reuse_fact"], s["h_fact"], h))
        when(need_fac.any(), lambda: self._factorize(need_fac),
             stream="factor")
        jac_computed = s["jac_computed"] | need_j
        nfcn = nfcn + njac * self.jac_extra
        nfac = need_fac.long()

        # trial values (radau5.rs:367)
        zt, wt = self._trial(h, s["h_prev"], s["yc"])
        zero = (first | self.zero_trial)[:, None, None]
        self.z.copy_(torch.where(zero, 0.0, zt))
        self.w.copy_(torch.where(zero, 0.0, wt))

        # simplified Newton (radau5.f 914-975), one body per iteration
        nw["theta"].fill_(self.theta_max)
        nw["eta"].copy_(lane_pow(torch.clamp_min(s["eta"], EPS), 0.8))
        for k in ("thq_old", "ldw_old"):
            nw[k].zero_()
        nw["h_mult"].fill_(1.0)
        for k in ("div", "conv", "done", "newt"):
            nw[k].zero_()
        for it in range(self.nit):
            run = go & ~nw["done"]
            when(run.any(), lambda it=it, run=run: self._newton(
                it + 1, run, s["x"], s["y"], h, scaling))

        n_it = nw["newt"]
        nfcn = nfcn + 3 * n_it
        nsol = s["n_lin_sol"] + n_it
        div = go & nw["div"]
        conv = go & ~nw["div"] & nw["conv"]
        put(s["n_jacobian"], go, s["n_jacobian"] + njac)
        put(s["n_factor"], go, s["n_factor"] + nfac)
        put(s["n_lin_sol"], go, nsol)
        put(s["n_iterations"], go, n_it)
        put(s["n_iterations_max"], go & ~nw["div"],
             torch.maximum(s["n_iterations_max"], n_it))
        put(s["n_function"], go, nfcn)
        put(s["eta"], go, nw["eta"])
        put(s["scaling"], go, scaling)
        put(s["k_acc"], go, k_acc)
        put(s["jac_computed"], go, jac_computed)
        # diverged: retry at a smaller step, recomputing J unless it is
        # fresh at (x, y) (the host consumes both reuse flags)
        for k in ("reuse_fact", "reuse_jac", "last_step"):
            put(s[k], div, False)
        put(s["follows_reject"], div, True)
        put(s["h_new"], div, h * nw["h_mult"])
        # not converged within n_iteration_max
        put(s["status"], go & ~nw["div"] & ~nw["conv"], 3)
        when(conv.any(), lambda: self._converged(
            conv, h, first, k_acc, scaling, nfcn))

    def _factorize(self, need):
        if self.B == 1:
            # drop the old pair first: two pairs alive at once double the
            # peak (as on the host path)
            self.fac = None
            self.fac = self._factor_pair(self.s["jv"], self.s["h_fact"])
        else:
            tree_commit(self.fac, self._factor_pair(self.s["jv"],
                                                    self.s["h_fact"]), need)

    def _drop_pair(self):
        """Before the capture: the warm-up's pair of one lane is made anew
        by the captured factorize body, in the graph's memory."""
        if self.B == 1:
            self.fac = None

    def _newton(self, newt, run, x, y, h, scaling):
        nw, nit = self.nw, self.nit
        wn, zn, ldw = self._newton_once(x, y, h, self.w, self.z, scaling)
        put(self.w, run, wn)
        put(self.z, run, zn)
        put(nw["newt"], run, newt)
        theta, thq_old, eta = nw["theta"], nw["thq_old"], nw["eta"]
        h_mult = nw["h_mult"]
        diverging = torch.zeros_like(run)
        if 1 < newt < nit:
            thq = ldw / torch.clamp_min(nw["ldw_old"], 1e-300)
            theta = thq if newt == 2 else torch.sqrt(thq * thq_old)
            thq_old = thq
            ok = theta < 0.99
            eta = torch.where(ok, theta / (1.0 - theta), eta)
            rel_err = lane_div(
                eta * ldw * lane_pow(theta, float(nit - 1 - newt)),
                self.tol_newton)
            q_newt = torch.clamp(rel_err, 1e-4, 20.0)
            h_mult_div = 0.8 * lane_pow(q_newt,
                                        -1.0 / float(4 + nit - 1 - newt))
            diverging = (ok & (rel_err >= 1.0)) | ~ok
            h_mult = torch.where(~ok, 0.5,
                                 torch.where(diverging, h_mult_div, h_mult))
        converged = eta * ldw < self.tol_newton
        put(nw["theta"], run, theta)
        put(nw["thq_old"], run, thq_old)
        put(nw["eta"], run, eta)
        put(nw["ldw_old"], run, ldw)
        put(nw["h_mult"], run, h_mult)
        put(nw["div"], run, diverging)
        put(nw["conv"], run, converged)
        put(nw["done"], run, diverging | converged)

    def _converged(self, conv, h, first, k_acc, scaling, nfcn):
        s = self.s
        z = self.z
        fr = self.fac[0]
        gamma = self._shifts(h)[2]
        ez = _R5["E0"] * z[:, 0] + _R5["E1"] * z[:, 1] + _R5["E2"] * z[:, 2]
        mez = gamma * (self._mass_mat_vec(ez) if self.has_mass else ez)
        err = self._solve(fr, mez + k_acc)
        self.rel.copy_(self._rel_error(err, scaling))
        redo = conv & (self.rel >= 1.0) & (first | s["follows_reject"])

        def second():
            fpe = self.lanes.function(s["x"], s["y"] + err)
            err2 = self._solve(fr, mez + fpe)
            put(self.rel, redo, self._rel_error(err2, scaling))

        when(redo.any(), second)
        rel = self.rel
        nfcn2 = nfcn + redo.long()
        acc = conv & (rel < 1.0)
        rej = conv & ~(rel < 1.0)
        n_it = self.nw["newt"]
        div = self._step_divisor(rel, n_it)
        put(s["rel_error"], conv, rel)
        put(s["n_function"], conv, nfcn2 + acc.long())

        # reject
        h_rej = torch.where(
            (s["n_accepted"] == 0) & (self.m_first_reject > 0.0),
            h * self.m_first_reject, h / div)
        put(s["n_rejected"], rej, s["n_rejected"]
             + (s["n_accepted"] > 0).long())
        put(s["follows_reject"], rej, True)
        for k in ("last_step", "reuse_fact", "reuse_jac"):
            put(s[k], rej, False)
        put(s["h_new"], rej, h_rej)
        when(acc.any(), lambda: self._accept(acc, h, div, z))

    def _accept(self, acc, h, div, z):
        s = self.s
        MU1, MU2, MU3 = _R5["MU1"], _R5["MU2"], _R5["MU3"]
        MU4, MU5 = _R5["MU4"], _R5["MU5"]
        y_new = s["y"] + z[:, 2]
        yc0 = (z[:, 1] - z[:, 2]) / MU4
        yc1 = ((z[:, 0] - z[:, 1]) / MU5 - yc0) / MU3
        yc2 = yc1 - ((z[:, 0] - z[:, 1]) / MU5 - z[:, 0] / MU1) / MU2
        yc = torch.stack([yc0, yc1, yc2], dim=1)
        rel = self.rel
        n_acc = s["n_accepted"] + 1
        h_new = h / div
        if self.use_pred:
            # Gustafsson predictive controller, from the second accept on
            r2 = rel * rel
            fac_g = torch.clamp(lane_div(
                (s["h_prev"] / h) * lane_pow(r2 / s["rel_error_prev"], 0.25),
                self.m_safety), self.m_min, self.m_max)
            h_new = torch.where(n_acc > 1, h / torch.maximum(div, fac_g),
                                h_new)
        h_ratio = h_new / h
        theta_ok = self.nw["theta"] <= self.theta_max
        reuse_fact = theta_ok & (h_ratio >= self.c1h) & (h_ratio <= self.c2h)
        reuse_jac = ~reuse_fact & theta_ok
        h_new = torch.where(reuse_fact, s["h_new"], h_new)
        # no growth right after a reject
        h_new = torch.where(s["follows_reject"], torch.minimum(h_new, h),
                            h_new)
        x_old = s["x"]
        x_new = x_old + h
        self.kf.copy_(self.lanes.function(x_new, y_new))
        if self.dense_xs is not None:
            # the host records station i at the first accept with
            # x_old < x_i <= x_new (output.rs:269)
            xs = self.dense_xs[None, :]
            mask = ((xs > x_old[:, None]) & (xs <= x_new[:, None])
                    & self.dense_ok[None, :] & acc[:, None])
            srel = ((xs - x_new[:, None]) / h[:, None])[:, :, None]
            pol = (y_new[:, None, :] + srel * (
                yc0[:, None, :] + (srel - MU4) * (
                    yc1[:, None, :] + (srel - MU3) * yc2[:, None, :])))
            s["dense_y"].copy_(torch.where(mask[:, :, None], pol,
                                           s["dense_y"]))
            s["dense_h"].copy_(torch.where(mask, h[:, None], s["dense_h"]))
        put(s["status"], acc & s["last_step"], 1)
        put(s["last_step"], acc, x_new + h_new >= s["x1"])
        put(s["x"], acc, x_new)
        put(s["y"], acc, y_new)
        put(s["yc"], acc, yc)
        put(s["h_prev"], acc, h)
        put(s["h_new"], acc, h_new)
        put(s["rel_error_prev"], acc,
             torch.clamp_min(rel, self.rel_error_prev_min))
        put(s["follows_reject"], acc, False)
        put(s["jac_computed"], acc, False)
        put(s["reuse_jac"], acc, reuse_jac)
        put(s["reuse_fact"], acc, reuse_fact)
        put(s["k_acc"], acc, self.kf)
        put(s["scaling"], acc, self.abs_tol + self.rel_tol * torch.abs(y_new))
        put(s["n_accepted"], acc, n_acc)

    # -- solving ------------------------------------------------------------

    def solve(self, x0: float, y0: torch.Tensor, x1: float, h0: float):
        """Integrate the lanes y0 (B, ndim) from x0 to x1 from step h0.
        Returns (y (B, ndim), stats) with stats a dict of (B,) tensors:
        ``status`` (1 done, 2 step too small, 3 Newton failed, 0 n_step_max
        reached), the counters, ``h_accepted`` and, with dense stations,
        ``dense_y``, ``dense_h`` and ``h_prev``."""
        self.start(x0, y0, x1, h0)
        self.loop.run()
        return self.result()

    def start(self, x0: float, y0: torch.Tensor, x1: float, h0: float):
        """Set the state to the start of an integration."""
        s, dev = self.s, self.device
        for t in s.values():
            t.zero_()
        s["x"].fill_(x0)
        s["x1"].fill_(x1)
        for k in ("h_new", "h_prev", "h_fact"):
            s[k].fill_(h0)
        s["rel_error_prev"].fill_(self.rel_error_prev_min)
        s["eta"].fill_(1.0)
        s["scaling"].fill_(1.0)
        s["y"].copy_(y0)
        s["jv"].copy_(self.lanes.jacobian(s["x"], s["y"]))
        if self.dense_xs is not None:
            # station 0 is (x0, y0) at the initial h (output.rs:423)
            s["dense_y"][:, 0] = s["y"]
            s["dense_h"][:, 0] = h0
        self.done.fill_(False)
        if not self._prepared:
            stream = None
            if dev.type == "cuda":
                stream = self.loop._stream("factor")
                check_capturable(
                    dev, ("function", self.lanes.f,
                          lambda: self.lanes.function(s["x"], s["y"])),
                    ("Jacobian", self.lanes.jac_fn,
                     lambda: self.lanes.jacobian(s["x"], s["y"])))
            _factor.prepare(self.plan, dev, stream, self.B)
            if self.B > 1:
                # the kept pair the lanes' factorizations commit into
                self.fac = self._factor_pair(s["jv"], s["h_fact"])
            self._prepared = True

    def result(self):
        """(y, stats) of the state, as ``solve`` returns them."""
        s = self.s
        stats = {k: s[k].clone() for k in ("status",) + _COUNTERS}
        stats["h_accepted"] = s["h_new"].clone()
        if self.dense_xs is not None:
            stats["dense_y"] = s["dense_y"].clone()
            stats["dense_h"] = s["dense_h"].clone()
            stats["h_prev"] = s["h_prev"].clone()
        return s["y"].clone(), stats
