"""Forward and backward Euler steppers, in PyTorch.

Counterpart of ``russell_tpu.ode.euler`` (reference behavior:
russell_ode/src/euler_forward.rs, explicit and didactic, and
euler_backward.rs, full Newton with the sparse linear solver on
K = h·J − I). The Newton iteration's device work (rhs, Jacobian values,
K assembly, factorize, solve, update, scaled-RMS norm) runs on the
state's device through ``factor`` on the frozen K structure, so
``analyze`` routes K as it routes Radau5's matrices (DENSE, SPLU or
GRIDMF); the convergence loop runs on the host so the iteration counters
match the reference contract.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.sparse import factor as _factor

__all__ = ["EulerForward", "EulerBackward"]


class EulerForward:
    """euler_forward.rs: w = y + h f(x, y)."""

    def __init__(self, system):
        self.system = system
        self._f = system.function
        self.w = None

    def enable_dense_output(self):
        raise ValueError("dense output is not available for the FwEuler method")

    def step(self, work, x, y, h, args):
        work.stats.n_function += 1
        k = self._f(x, y, args)
        self.w = y + h * k

    def accept(self, work, x, y, h, args):
        return x + h, self.w

    def reject(self, work, h):
        pass

    def dense_output(self, x_out, x, y, h):
        raise ValueError("dense output is not available for the FwEuler method")

    def update_params(self, params):
        pass


class EulerBackward:
    """euler_backward.rs: full Newton on r = y_new - y - h f(x_new, y_new)."""

    def __init__(self, params, system):
        self.params = params
        self.system = system
        self._f = system.function
        self.w = None
        use_num = params.newton.use_numerical_jacobian
        (jac_ii, jac_jj), self._jac_fn = system.jac_values_fn(use_num)
        self._numerical = use_num or system.jacobian is None
        n = system.ndim
        # K = h J - I structure: jacobian entries + diagonal
        ii = np.concatenate([np.asarray(jac_ii), np.arange(n)])
        jj = np.concatenate([np.asarray(jac_jj), np.arange(n)])
        lsp = params.newton.lin_sol_params
        self.plan = _factor.analyze(
            n, ii, jj, genie=params.newton.genie, grid=system.grid,
            **({} if lsp is None else dict(
                ordering=lsp.ordering, scaling=lsp.scaling,
                pivot_epsilon=lsp.pivot_epsilon,
                refine_steps=lsp.refinement_nstep,
                dense_threshold=lsp.dense_threshold)))
        self._fac = None

    # -- the iteration's device work ------------------------------------------

    def _residual(self, x_new, y_new, y, h, args):
        """(r, ||r|| scaled RMS as a host float)."""
        tol = self.params.tol
        r = y_new - y - h * self._f(x_new, y_new, args)
        den = tol.abs + tol.rel * torch.abs(y)
        q = r / den
        return r, float(torch.sqrt(torch.sum(q * q) / y.shape[0]))

    def _factorize(self, x_new, y_new, h, args):
        jv = self._jac_fn(x_new, y_new, args)
        data = torch.cat([h * jv, -torch.ones(self.system.ndim,
                                              dtype=jv.dtype,
                                              device=jv.device)])
        self._fac = None  # drop the old factors before making new ones
        self._fac = _factor._numeric_factorize(self.plan, data)

    def _solve(self, r):
        return _factor.factor_solve(self.plan, self._fac, r)

    # -- OdeSolverTrait surface ----------------------------------------------

    def enable_dense_output(self):
        raise ValueError("dense output is not available for the BwEuler method")

    def step(self, work, x, y, h, args):
        traditional = not self.params.bweuler.use_modified_newton
        ndim = self.system.ndim
        x_new = x + h
        y_new = y
        success = False
        work.stats.n_iterations = 0
        for _ in range(self.params.newton.n_iteration_max):
            work.stats.n_iterations += 1
            work.stats.n_function += 1
            r, r_norm = self._residual(x_new, y_new, y, h, args)
            if r_norm < self.params.tol.newton:
                success = True
                break
            if traditional or work.stats.n_accepted == 0:
                work.stats.sw_jacobian.reset()
                work.stats.n_jacobian += 1
                if self._numerical:
                    work.stats.n_function += ndim
                work.stats.stop_sw_jacobian()
                work.stats.sw_factor.reset()
                work.stats.n_factor += 1
                self._factorize(x_new, y_new, h, args)
                work.stats.stop_sw_factor()
            work.stats.sw_lin_sol.reset()
            work.stats.n_lin_sol += 1
            dy = self._solve(r)
            work.stats.stop_sw_lin_sol()
            y_new = y_new + dy
        work.stats.update_n_iterations_max()
        if not success:
            raise RuntimeError(
                "Newton-Raphson method did not complete successfully")
        self.w = y_new

    def accept(self, work, x, y, h, args):
        return x + h, self.w

    def reject(self, work, h):
        pass

    def dense_output(self, x_out, x, y, h):
        raise ValueError("dense output is not available for the BwEuler method")

    def update_params(self, params):
        self.params = params
