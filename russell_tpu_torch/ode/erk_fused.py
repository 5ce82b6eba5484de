"""The whole embedded explicit Runge-Kutta integration on the device, in
PyTorch.

Counterpart of ``russell_tpu.ode.erk_fused`` (``build_fused_erk_solver``):
the variable-step loop (ode_solver.rs:278-366) with the embedded error
estimate and the Lund-stabilized controller of explicit_runge_kutta.rs as
one step attempt over state on the device, run by
``_device_loop.DeviceLoop`` (on the card one CUDA graph replayed, the
host reading only a done flag). The fresh first stage (not FSAL-reusable)
and the whole attempt once the integration is done sit under ``when``,
as the reference's ``lax.cond`` / ``lax.while_loop``; the stages and the
controller are plain device arithmetic, in the host path's operations and
order (``erk.py``, whose scalar tail runs on the host in f64), so the
counters are the host path's.

Dense stations (DoPri5, DoPri8, with DoPri8's 3 extra function
evaluations on each accepted step) are scattered into an (n_out, ndim)
buffer per lane as the host's ``ErkDenseOut`` evaluates them. Step
output, callbacks and stiffness detection need the host path. Like
``radau5_fused``, the step runs over a leading lane dimension B.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.ode import constants as C
from russell_tpu_torch.ode._device_loop import (DeviceLoop, check_capturable,
                                                when)
from russell_tpu_torch.ode.enums import Method
from russell_tpu_torch.ode._lanes import (Lanes, lane_div, lane_pow,
                                          lane_sum, put)

__all__ = ["FusedErk"]

EPS = 2.220446049250313e-16
_COUNTERS = ("n_steps", "n_accepted", "n_rejected", "n_function")


class FusedErk:
    """One fused integration of ``lanes`` lanes for an embedded
    ``ExplicitRungeKutta`` stepper, with dense stations ``dense_x``
    (sorted, x0 and x1 included; DoPri5 and DoPri8) or none."""

    def __init__(self, stepper, params, device, lanes: int = 1,
                 dense_x=None):
        info = params.method.information()
        if not info.embedded:
            raise ValueError("the fused ERK solver requires an embedded "
                             "method")
        self.method = params.method
        self.A, self.Bw, self.Cc, self.E = (stepper.A, stepper.B, stepper.Cc,
                                            stepper.E)
        self.nstage = stepper.nstage
        self.fsal = info.first_step_same_as_last
        self.abs_tol, self.rel_tol = params.tol.abs, params.tol.rel
        self.lund_factor = stepper.lund_factor
        self.lund_beta = params.erk.lund_beta
        self.m_safety = params.step.m_safety
        self.m_first_reject = params.step.m_first_reject
        self.d_min, self.d_max = stepper.d_min, stepper.d_max
        self.rel_error_prev_min = params.step.rel_error_prev_min
        self.n_step_max = params.step.n_step_max
        system = stepper.system
        self.ndim = n = system.ndim
        self.device = dev = torch.device(device)
        self.B = B = int(lanes)
        self.lanes = Lanes(system, None, B)

        f64 = dict(dtype=torch.float64, device=dev)
        s = self.s = {}
        for k in ("x", "x1", "h_new", "h_prev", "rel_error",
                  "rel_error_prev"):
            s[k] = torch.zeros(B, **f64)
        for k in ("have_k", "follows_reject", "last_step"):
            s[k] = torch.zeros(B, dtype=torch.bool, device=dev)
        for k in ("status", "iter_count") + _COUNTERS:
            s[k] = torch.zeros(B, dtype=torch.int64, device=dev)
        s["y"] = torch.zeros(B, n, **f64)
        s["k_last"] = torch.zeros(B, n, **f64)
        self.dense_xs = None
        if dense_x is not None:
            if self.method not in (Method.DOPRI5, Method.DOPRI8):
                raise ValueError("fused ERK dense output requires DoPri5 or "
                                 "DoPri8 (erk_dense_out.rs contract)")
            xs = np.asarray(dense_x, dtype=np.float64)
            if len(xs) < 2:
                raise ValueError("dense_x must include x0 and x1")
            self.dense_xs = torch.as_tensor(xs, device=dev)
            self.dense_ok = torch.arange(len(xs), device=dev) < len(xs) - 1
            s["dense_y"] = torch.zeros(B, len(xs), n, **f64)
            s["dense_h"] = torch.zeros(B, len(xs), **f64)
        self.k0 = torch.zeros(B, n, **f64)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.loop = DeviceLoop(self._attempt, list(s.values()), self.done,
                               dev)
        self._checked = False

    # -- the step's arithmetic (erk.py's, over a leading lane dimension) ----

    def _stages(self, x, y, h, k0):
        A, Bw, Cc = self.A, self.Bw, self.Cc
        F = self.lanes.function
        hc = h[:, None]
        ks = [k0]
        for i in range(1, self.nstage):
            vi = y
            for j in range(i):
                a = A[i][j]
                if a != 0.0:
                    vi = vi + (hc * a) * ks[j]
            ks.append(F(x + h * Cc[i], vi))
        w = y
        for i in range(self.nstage):
            if Bw[i] != 0.0:
                w = w + (Bw[i] * hc) * ks[i]
        return ks, w

    def _rel_error(self, y, h, w, ks):
        Bw, E = self.Bw, self.E
        sk = self.abs_tol + self.rel_tol * torch.maximum(torch.abs(y),
                                                         torch.abs(w))
        hc = h[:, None]
        if self.method == Method.DOPRI8:
            # 8(5,3) double error estimate (dop853.f; HW-I Eq. 10.17)
            err_a = torch.zeros_like(y)
            err_b = torch.zeros_like(y)
            for i in range(self.nstage):
                if Bw[i] != 0.0:
                    err_a = err_a + Bw[i] * ks[i]
                if E[i] != 0.0:
                    err_b = err_b + E[i] * ks[i]
            err_a = (err_a - C.DOPRI8_BHH1 * ks[0] - C.DOPRI8_BHH2 * ks[8]
                     - C.DOPRI8_BHH3 * ks[11])
            ra, rb = err_a / sk, err_b / sk
            err_3 = lane_sum(ra * ra)
            err_5 = lane_sum(rb * rb)
            den = err_5 + 0.01 * err_3
            den = torch.where(den <= 0.0, 1.0, den)
            return torch.abs(h) * err_5 * torch.sqrt(
                lane_div(1.0, self.ndim * den))
        err_m = torch.zeros_like(y)
        for i in range(self.nstage):
            if E[i] != 0.0:
                err_m = err_m + (E[i] * hc) * ks[i]
        ratio = err_m / sk
        return torch.clamp_min(torch.sqrt(
            lane_div(lane_sum(ratio * ratio), float(self.ndim))),
            1e-10)

    def _dense(self, x_old, y, h, w, ks, x_new):
        """The stations' values (B, n_out, ndim) of the accepted step
        x_old -> x_new, as ``ErkDenseOut.update`` then ``calculate``
        compute them on the host path."""
        hc = h[:, None]
        y_diff = w - y
        b_spl = hc * ks[0] - y_diff
        # theta = (x_out - (x - h)) / h at x = x_new (erk_dense_out.py)
        theta = ((self.dense_xs[None, :] - (x_new - h)[:, None])
                 / h[:, None])[:, :, None]
        u = 1.0 - theta
        if self.method == Method.DOPRI5:
            dd = C.DOPRI5_D.tolist()
            d3 = y_diff - hc * ks[6] - b_spl
            d4 = hc * (dd[0] * ks[0] + dd[2] * ks[2] + dd[3] * ks[3]
                       + dd[4] * ks[4] + dd[5] * ks[5] + dd[6] * ks[6])
            d = [y, y_diff, b_spl, d3, d4]
            d = [v[:, None, :] for v in d]
            return d[0] + theta * (d[1] + u * (d[2] + theta * (
                d[3] + u * d[4])))
        dd, aad, ccd = (C.DOPRI8_D.tolist(), C.DOPRI8_AD.tolist(),
                        C.DOPRI8_CD.tolist())

        def comb(row, kd_list):
            # column 12 multiplies k[11] again (dop853's 13th stage is
            # FSAL); columns 13.. multiply the extra stages
            acc = torch.zeros_like(y)
            for j in range(12):
                if row[j] != 0.0:
                    acc = acc + row[j] * ks[j]
            if row[12] != 0.0:
                acc = acc + row[12] * ks[11]
            for extra, kd in enumerate(kd_list):
                if row[13 + extra] != 0.0:
                    acc = acc + row[13 + extra] * kd
            return acc

        kd = []
        for sx in range(3):
            yd = y + hc * comb(aad[sx], kd)
            kd.append(self.lanes.function(x_old + ccd[sx] * h, yd))
        d3 = y_diff - hc * ks[11] - b_spl
        drows = [hc * comb(dd[r], kd) for r in range(4)]
        d = [v[:, None, :] for v in [y, y_diff, b_spl, d3] + drows]
        par = d[4] + theta * (d[5] + u * (d[6] + theta * d[7]))
        return d[0] + theta * (d[1] + u * (d[2] + theta * (d[3] + u * par)))

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
        s = self.s
        x, y = s["x"], s["y"]
        # k0: fresh unless FSAL-reusable (erk.rs:164-167)
        fresh = ((((s["n_accepted"] == 0) | (not self.fsal))
                  & ~s["follows_reject"]) | ~s["have_k"])
        need = go & fresh
        when(need.any(), lambda: self.k0.copy_(self.lanes.function(x, y)))
        k0 = torch.where(need[:, None], self.k0, s["k_last"])
        nfcn = s["n_function"] + fresh.long() + (self.nstage - 1)
        ks, w = self._stages(x, y, h, k0)
        rel = self._rel_error(y, h, w, ks)
        s["n_steps"].add_(go.long())
        acc = go & (rel < 1.0)
        rej = go & ~(rel < 1.0)
        put(s["rel_error"], go, rel)
        put(s["have_k"], go, True)

        # reject
        d = lane_div(lane_pow(rel, self.lund_factor), self.m_safety)
        h_rej = torch.where(
            (s["n_accepted"] == 0) & (self.m_first_reject > 0.0),
            h * self.m_first_reject, h / torch.clamp_max(d, self.d_min))
        put(s["n_rejected"], rej, s["n_rejected"]
             + (s["n_accepted"] > 0).long())
        put(s["n_function"], rej, nfcn)
        put(s["h_new"], rej, h_rej)
        put(s["k_last"], rej, ks[0])
        put(s["follows_reject"], rej, True)
        put(s["last_step"], rej, False)

        # accept (dopri5.f lines 463-467)
        fac = lane_pow(rel, self.lund_factor)
        if self.lund_beta > 0.0:
            fac = fac / lane_pow(s["rel_error_prev"], self.lund_beta)
        fac = torch.clamp(lane_div(fac, self.m_safety), self.d_max,
                          self.d_min)
        h_new = h / fac
        h_new = torch.where(s["follows_reject"], torch.minimum(h_new, h),
                            h_new)
        x_new = x + h
        n_extra = 0
        if self.dense_xs is not None:
            n_extra = 3 if self.method == Method.DOPRI8 else 0
            when(acc.any(), lambda: self._scatter(acc, x, y, h, w, ks,
                                                  x_new))
        put(s["n_function"], acc, nfcn + n_extra)
        put(s["status"], acc & s["last_step"], 1)
        put(s["last_step"], acc, x_new + h_new >= s["x1"])
        put(s["k_last"], acc, ks[self.nstage - 1] if self.fsal else ks[0])
        put(s["x"], acc, x_new)
        put(s["y"], acc, w)
        put(s["h_new"], acc, h_new)
        put(s["h_prev"], acc, h)
        put(s["rel_error_prev"], acc,
             torch.clamp_min(rel, self.rel_error_prev_min))
        put(s["follows_reject"], acc, False)
        put(s["n_accepted"], acc, s["n_accepted"] + 1)

    def _scatter(self, acc, x_old, y, h, w, ks, x_new):
        # the host records station i at the first accept with
        # x_old < x_i <= x_new (output.rs:269)
        s = self.s
        xs = self.dense_xs[None, :]
        mask = ((xs > x_old[:, None]) & (xs <= x_new[:, None])
                & self.dense_ok[None, :] & acc[:, None])
        pol = self._dense(x_old, y, h, w, ks, x_new)
        s["dense_y"].copy_(torch.where(mask[:, :, None], pol, s["dense_y"]))
        s["dense_h"].copy_(torch.where(mask, h[:, None], s["dense_h"]))

    # -- solving ------------------------------------------------------------

    def solve(self, x0: float, y0: torch.Tensor, x1: float, h0: float):
        """Integrate the lanes y0 (B, ndim) from x0 to x1 from step h0.
        Returns (y (B, ndim), stats): a dict of (B,) tensors with
        ``status`` (1 done, 2 step too small, 0 n_step_max reached), the
        counters, ``h_prev``, ``h_accepted`` and, with dense stations,
        ``dense_y`` and ``dense_h``."""
        self.start(x0, y0, x1, h0)
        self.loop.run()
        return self.result()

    def start(self, x0: float, y0: torch.Tensor, x1: float, h0: float):
        """Set the state to the start of an integration."""
        s = self.s
        for t in s.values():
            t.zero_()
        s["x"].fill_(x0)
        s["x1"].fill_(x1)
        s["h_new"].fill_(h0)
        s["h_prev"].fill_(h0)
        s["rel_error_prev"].fill_(self.rel_error_prev_min)
        s["y"].copy_(y0)
        if self.dense_xs is not None:
            # station 0 is (x0, y0) at the initial h (output.rs:423)
            s["dense_y"][:, 0] = s["y"]
            s["dense_h"][:, 0] = h0
        self.done.fill_(False)
        if self.device.type == "cuda" and not self._checked:
            check_capturable(self.device, (
                "function", self.lanes.f,
                lambda: self.lanes.function(s["x"], s["y"])))
            self._checked = True

    def result(self):
        """(y, stats) of the state, as ``solve`` returns them."""
        s = self.s
        stats = {k: s[k].clone() for k in ("status",) + _COUNTERS}
        stats["h_prev"] = s["h_prev"].clone()
        stats["h_accepted"] = s["h_new"].clone()
        if self.dense_xs is not None:
            stats["dense_y"] = s["dense_y"].clone()
            stats["dense_h"] = s["dense_h"].clone()
        return s["y"].clone(), stats
