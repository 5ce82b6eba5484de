"""Radau IIA order 5 (implicit, embedded) for ODEs and DAEs, in PyTorch.

Counterpart of ``russell_tpu.ode.radau5`` (reference behavior:
russell_ode/src/radau5.rs, a line-faithful restatement of Hairer-Wanner's
radau5.f; constants from radau5.f).

- The two Newton coefficient matrices K_real = γM − J (real) and
  K_comp = (α+βι)M − J (complex) share one frozen sparsity structure
  (Jacobian entries + mass entries) and are factorized together in one
  pass of the SPLU schedule (radau5.rs:270-296, P5).
- Each simplified-Newton iteration (3 rhs evaluations, TI transform,
  real+complex solves, w/z update, scaled RMS norm) runs on the tensors'
  device; the convergence/divergence control (θ, η — radau5.f lines
  914-967) runs on the host in f64 so the statistics counters match the
  Fortran oracles exactly.
- Collocation dense output and the Gustafsson predictive controller
  (radau5.rs:589) follow the reference formulas.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch

from russell_tpu_torch.ode.constants import radau5_constants
from russell_tpu_torch.sparse import factor as _factor
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.matrix_market import write_matrix_market

__all__ = ["Radau5"]

EPS = 2.220446049250313e-16
_R5 = radau5_constants()


def _sync(device):
    """Wait for ``device`` (so the stopwatches time the work, not its
    enqueue)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Radau5:
    def __init__(self, params, system, device):
        self.params = params
        self.system = system
        self.device = torch.device(device)
        ndim = system.ndim
        use_num = params.newton.use_numerical_jacobian
        (jac_ii, jac_jj), self._jac_fn = system.jac_values_fn(use_num)
        self._numerical = use_num or system.jacobian is None

        # mass structure/values (diagonal identity when no mass; radau5.rs:131)
        if system.mass is not None:
            m_ii, m_jj, m_vv = system.mass.triplets()
            self._has_mass = True
        else:
            m_ii = m_jj = np.arange(ndim)
            m_vv = np.ones(ndim)
            self._has_mass = False
        self._mass_ii = np.asarray(m_ii, dtype=np.int64)
        self._mass_jj = np.asarray(m_jj, dtype=np.int64)
        self._mass_vv = np.asarray(m_vv, dtype=np.float64)

        # shared K structure = [jac entries][mass entries]
        ii = np.concatenate([jac_ii, self._mass_ii])
        jj = np.concatenate([jac_jj, self._mass_jj])
        lsp = params.newton.lin_sol_params
        kw = {} if lsp is None else dict(
            ordering=lsp.ordering, scaling=lsp.scaling,
            pivot_epsilon=lsp.pivot_epsilon,
            refine_steps=lsp.refinement_nstep,
            dense_threshold=lsp.dense_threshold)
        self.plan = _factor.analyze(ndim, ii, jj, genie=params.newton.genie,
                                    grid=system.grid, **kw)

        dev = self.device
        self._mass_vv_d = torch.as_tensor(self._mass_vv, device=dev)
        self._mass_ii_d = torch.as_tensor(self._mass_ii, device=dev)
        self._mass_jj_d = torch.as_tensor(self._mass_jj, device=dev)
        self._f = system.function

        # state
        self.scaling = None
        self.k_accepted = None
        self.z = None          # (3, ndim)
        self.w = None          # (3, ndim)
        self.yc = None         # (3, ndim) collocation values
        self.fac_real = None
        self.fac_comp = None
        self.reuse_jacobian = False
        self.reuse_jacobian_kk_and_fact = False
        self.jacobian_computed = False
        self._jv = None
        self.eta = 1.0
        self.theta = params.radau5.theta_max

    # -- device steps ---------------------------------------------------------

    def _mass_mat_vec(self, w):
        out = torch.zeros(self.system.ndim, dtype=w.dtype, device=w.device)
        return out.index_add_(0, self._mass_ii_d,
                              self._mass_vv_d * w[self._mass_jj_d])

    def _factorize(self, jv, h):
        alpha, beta, gamma = _R5["ALPHA"] / h, _R5["BETA"] / h, _R5["GAMMA"] / h
        mass = self._mass_vv_d
        data_r = torch.cat([-jv, gamma * mass])
        data_c = torch.cat([-jv.to(torch.complex128),
                            (alpha + 1j * beta) * mass.to(torch.complex128)])
        # both factorizations share one pass over the schedule (P5)
        return _factor.numeric_factorize_pair(self.plan, data_r, data_c)

    def _newton_iter(self, x, y, h, w, z, args):
        """One simplified-Newton iteration; returns (w, z, ldw) with ldw a
        0-dim device tensor."""
        f = self._f
        ndim = self.system.ndim
        A, B, G = _R5["ALPHA"], _R5["BETA"], _R5["GAMMA"]
        T, TI, C = _R5["T"], _R5["TI"], _R5["C"]
        alpha, beta, gamma = A / h, B / h, G / h
        u = x + C * h
        v0, v1, v2 = y + z[0], y + z[1], y + z[2]
        k0 = f(u[0], v0, args)
        k1 = f(u[1], v1, args)
        k2 = f(u[2], v2, args)
        if self._has_mass:
            l0, l1, l2 = (self._mass_mat_vec(w[0]), self._mass_mat_vec(w[1]),
                          self._mass_mat_vec(w[2]))
        else:
            l0, l1, l2 = w[0], w[1], w[2]
        r0 = TI[0, 0] * k0 + TI[0, 1] * k1 + TI[0, 2] * k2 - gamma * l0
        r1 = (TI[1, 0] * k0 + TI[1, 1] * k1 + TI[1, 2] * k2
              - alpha * l1 + beta * l2)
        r2 = (TI[2, 0] * k0 + TI[2, 1] * k1 + TI[2, 2] * k2
              - beta * l1 - alpha * l2)
        rc = torch.complex(r1, r2)
        # real + complex solves share one substitution pass; the Newton
        # loop tolerates unrefined solves (refine_steps=0, as in the
        # reference package's f64 path)
        dw0, dw12 = _factor.factor_solve_pair(self.plan, self.fac_real,
                                              self.fac_comp, r0, rc,
                                              refine_steps=0)
        w0 = w[0] + dw0
        w1 = w[1] + dw12.real
        w2 = w[2] + dw12.imag
        wn = torch.stack([w0, w1, w2])
        zn = torch.stack([
            T[0, 0] * w0 + T[0, 1] * w1 + T[0, 2] * w2,
            T[1, 0] * w0 + T[1, 1] * w1 + T[1, 2] * w2,
            T[2, 0] * w0 + T[2, 1] * w1 + T[2, 2] * w2])
        scaling = self.scaling
        ldw = torch.sqrt((torch.sum((dw0 / scaling) ** 2)
                          + torch.sum((dw12.real / scaling) ** 2)
                          + torch.sum((dw12.imag / scaling) ** 2))
                         / (3.0 * ndim))
        return wn, zn, ldw

    def _trial(self, h, h_prev, yc):
        TI = _R5["TI"]
        c3q = h / h_prev
        c1q = _R5["MU1"] * c3q
        c2q = _R5["MU2"] * c3q
        MU3, MU4 = _R5["MU3"], _R5["MU4"]

        def poly(cq):
            return cq * (yc[0] + (cq - MU4) * (yc[1] + (cq - MU3) * yc[2]))

        z = torch.stack([poly(c1q), poly(c2q), poly(c3q)])
        w = torch.stack([
            TI[0, 0] * z[0] + TI[0, 1] * z[1] + TI[0, 2] * z[2],
            TI[1, 0] * z[0] + TI[1, 1] * z[1] + TI[1, 2] * z[2],
            TI[2, 0] * z[0] + TI[2, 1] * z[1] + TI[2, 2] * z[2]])
        return z, w

    def _err_estimate(self, z, h):
        gamma = _R5["GAMMA"] / h
        ez = _R5["E0"] * z[0] + _R5["E1"] * z[1] + _R5["E2"] * z[2]
        if self._has_mass:
            mez = gamma * self._mass_mat_vec(ez)
        else:
            mez = gamma * ez
        err = _factor.factor_solve(self.plan, self.fac_real,
                                   mez + self.k_accepted, refine_steps=0)
        return err, mez, self._rel_error(err)

    def _err_estimate2(self, mez, fpe):
        err = _factor.factor_solve(self.plan, self.fac_real, mez + fpe,
                                   refine_steps=0)
        return self._rel_error(err)

    def _rel_error(self, err):
        ndim = self.system.ndim
        return torch.clamp_min(
            torch.sqrt(torch.sum((err / self.scaling) ** 2) / ndim), 1e-10)

    @staticmethod
    def _collocation(y, z):
        MU1, MU2, MU3, MU5 = (_R5["MU1"], _R5["MU2"], _R5["MU3"],
                              _R5["MU5"])
        MU4 = _R5["MU4"]
        yc0 = (z[1] - z[2]) / MU4
        yc1 = ((z[0] - z[1]) / MU5 - yc0) / MU3
        yc2 = yc1 - ((z[0] - z[1]) / MU5 - z[0] / MU1) / MU2
        return y + z[2], torch.stack([yc0, yc1, yc2])

    # -- helpers --------------------------------------------------------------

    def _initialize(self, work, x, y, args):
        """Scaling vector + first function eval (radau5.rs:186)."""
        self.scaling = (self.params.tol.abs
                        + self.params.tol.rel * torch.abs(y))
        work.stats.n_function += 1
        self.k_accepted = self._f(x, y, args)

    # -- OdeSolverTrait surface ----------------------------------------------

    def step(self, work, x, y, h, args):
        if work.stats.n_accepted == 0:
            self._initialize(work, x, y, args)
        ndim = self.system.ndim

        # assemble + factorize (simple Newton: frozen within the step)
        if self.reuse_jacobian_kk_and_fact:
            self.reuse_jacobian_kk_and_fact = False
        else:
            if self.reuse_jacobian:
                self.reuse_jacobian = False
            elif not self.jacobian_computed:
                work.stats.sw_jacobian.reset()
                work.stats.n_jacobian += 1
                if self._numerical:
                    work.stats.n_function += ndim
                self._jv = self._jac_fn(x, y, args)
                self.jacobian_computed = True
                work.stats.stop_sw_jacobian()
            # dump-and-die debugging (radau5.rs:242-254)
            nstep = self.params.newton.write_matrix_after_nstep_and_stop
            if nstep is not None and work.stats.n_accepted > nstep:
                out_dir = self._write_matrices(h)
                raise RuntimeError(f"MATRIX FILES GENERATED in {out_dir}/")
            work.stats.sw_factor.reset()
            work.stats.n_factor += 1
            # drop the old pair first: two pairs alive at once doubled the
            # peak device memory (33.2 GB at npoint 513 on an H100)
            self.fac_real = self.fac_comp = None
            self.fac_real, self.fac_comp = self._factorize(self._jv, h)
            _sync(self.device)
            work.stats.stop_sw_factor()

        # trial values (radau5.rs:367-390)
        if work.stats.n_accepted == 0 or self.params.radau5.zero_trial:
            z = torch.zeros((3, ndim), dtype=y.dtype, device=y.device)
            w = torch.zeros_like(z)
        else:
            z, w = self._trial(h, work.h_prev, self.yc)

        # Newton control state (radau5.f lines 914-931)
        self.eta = max(self.eta, EPS) ** 0.8
        self.theta = self.params.radau5.theta_max
        ldw_old = 0.0
        thq_old = 0.0
        nit = self.params.newton.n_iteration_max
        success = False
        work.iterations_diverging = False
        work.stats.n_iterations = 0

        for _ in range(nit):
            work.stats.n_iterations += 1
            work.stats.n_function += 3
            work.stats.sw_lin_sol.reset()
            work.stats.n_lin_sol += 1
            w, z, ldw_dev = self._newton_iter(x, y, h, w, z, args)
            ldw = float(ldw_dev)
            work.stats.stop_sw_lin_sol()

            newt = work.stats.n_iterations
            if newt > 1 and newt < nit:
                thq = ldw / ldw_old
                if newt == 2:
                    self.theta = thq
                else:
                    self.theta = math.sqrt(thq * thq_old)
                thq_old = thq
                if self.theta < 0.99:
                    self.eta = self.theta / (1.0 - self.theta)
                    exp = float(nit - 1 - newt)
                    rel_err = (self.eta * ldw * self.theta ** exp
                               / self.params.tol.newton)
                    if rel_err >= 1.0:  # diverging
                        q_newt = max(1e-4, min(20.0, rel_err))
                        den = float(4 + nit - 1 - newt)
                        work.h_multiplier_diverging = \
                            0.8 * q_newt ** (-1.0 / den)
                        work.iterations_diverging = True
                        self.z, self.w = z, w
                        return
                else:  # diverging badly
                    work.h_multiplier_diverging = 0.5
                    work.iterations_diverging = True
                    self.z, self.w = z, w
                    return
            ldw_old = ldw
            if self.eta * ldw < self.params.tol.newton:
                success = True
                break

        work.stats.update_n_iterations_max()
        if not success:
            raise RuntimeError(
                "Newton-Raphson method did not complete successfully")
        self.z, self.w = z, w

        # error estimate (HW-VII p123 Eq. 8.20; radau5.rs:536-585)
        err, mez, rel = self._err_estimate(z, h)
        work.rel_error = float(rel)
        if work.rel_error < 1.0:
            return
        if work.stats.n_accepted == 0 or work.follows_reject_step:
            work.stats.n_function += 1
            fpe = self._f(x, y + err, args)
            work.rel_error = float(self._err_estimate2(mez, fpe))

    def _write_matrices(self, h):
        """Write J, K_real, K_comp as MatrixMarket and vismatrix files
        (radau5.rs write_matrix_after_nstep_and_stop) into
        ``$TMPDIR/russell_tpu_torch``; returns that directory."""
        out_dir = os.path.join(tempfile.gettempdir(), "russell_tpu_torch")
        os.makedirs(out_dir, exist_ok=True)
        ndim = self.system.ndim
        jv = self._jv.detach().cpu().numpy()
        rows = self.plan.rows[: len(jv)]
        cols = self.plan.cols[: len(jv)]
        jac = CooMatrix.from_arrays(ndim, ndim, rows, cols, jv)
        A, B, G = _R5["ALPHA"], _R5["BETA"], _R5["GAMMA"]
        kr = np.concatenate([-jv, (G / h) * self._mass_vv])
        kc = np.concatenate([-jv.astype(np.complex128),
                             ((A + 1j * B) / h) * self._mass_vv])
        k_rows = np.concatenate([rows, self._mass_ii])
        k_cols = np.concatenate([cols, self._mass_jj])
        kk_real = CooMatrix.from_arrays(ndim, ndim, k_rows, k_cols, kr)
        kk_comp = CooMatrix.from_arrays(ndim, ndim, k_rows, k_cols, kc)
        for name, m in (("jacobian", jac), ("kk_real", kk_real),
                        ("kk_comp", kk_comp)):
            write_matrix_market(m, os.path.join(out_dir, f"{name}.mtx"))
            write_matrix_market(m, os.path.join(out_dir, f"{name}.smat"),
                                vismatrix=True)
        return out_dir

    def enable_dense_output(self):
        pass  # collocation polynomial always available

    def accept(self, work, x, y, h, args):
        self.reuse_jacobian_kk_and_fact = False
        self.reuse_jacobian = False
        self.jacobian_computed = False

        y_new, self.yc = self._collocation(y, self.z)

        # stepsize estimate (radau5.f; radau5.rs:609-625)
        newt = work.stats.n_iterations
        nit = self.params.newton.n_iteration_max
        num = self.params.step.m_safety * (1 + 2 * nit)
        den = newt + 2 * nit
        fac = min(self.params.step.m_safety, num / den)
        div = max(self.params.step.m_min,
                  min(self.params.step.m_max, work.rel_error ** 0.25 / fac))
        h_new = h / div

        # Gustafsson predictive controller
        if self.params.radau5.use_pred_control and work.stats.n_accepted > 1:
            r2 = work.rel_error * work.rel_error
            rp = work.rel_error_prev
            fac_g = ((work.h_prev / h) * (r2 / rp) ** 0.25
                     / self.params.step.m_safety)
            fac_g = max(self.params.step.m_min,
                        min(self.params.step.m_max, fac_g))
            div = max(div, fac_g)
            h_new = h / div

        h_ratio = h_new / h
        self.reuse_jacobian_kk_and_fact = (
            self.theta <= self.params.radau5.theta_max
            and h_ratio >= self.params.radau5.c1h
            and h_ratio <= self.params.radau5.c2h)
        if not self.reuse_jacobian_kk_and_fact:
            work.h_new = h_new
            self.reuse_jacobian = self.theta <= self.params.radau5.theta_max

        x_new = x + h
        self._initialize(work, x_new, y_new, args)
        return x_new, y_new

    def reject(self, work, h):
        newt = work.stats.n_iterations
        nit = self.params.newton.n_iteration_max
        num = self.params.step.m_safety * (1 + 2 * nit)
        den = newt + 2 * nit
        fac = min(self.params.step.m_safety, num / den)
        div = max(self.params.step.m_min,
                  min(self.params.step.m_max, work.rel_error ** 0.25 / fac))
        work.h_new = h / div

    def dense_output(self, x_out, x, y, h):
        """Collocation polynomial interpolation (radau5.rs:669)."""
        assert x - h <= x_out <= x
        s = (x_out - x) / h
        MU3, MU4 = _R5["MU3"], _R5["MU4"]
        yc = self.yc
        return y + s * (yc[0] + (s - MU4) * (yc[1] + (s - MU3) * yc[2]))

    def update_params(self, params):
        self.params = params
