"""Dense Newton-Raphson solver for F(u) = 0.

Counterpart of ``russell_tpu.algo.newton_solver`` (reference contract:
russell_lab/src/algo/newton_solver.rs:22 — scaled residual convergence,
optional analytical Jacobian, numerical Jacobian fallback, Stats
counters). u, F and J live on one device: ``u0``'s (``device=`` for a
float, list or numpy array, the card by default); the Jacobian is
``torch.func.jacfwd`` of ``f`` unless given, the step
``torch.linalg.solve`` there. The one host read an iteration is the
scaled residual norm, as in the reference. ``num_jacobian`` is host
numpy, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from russell_tpu_torch.algo.stats import Stats
from russell_tpu_torch.core._place import div, f64, host, on

__all__ = ["NewtonSolver", "num_jacobian"]


def num_jacobian(f, x, u, args=None):
    """Dense Jacobian by central differences
    (russell_lab/src/algo/num_jacobian.rs:80): host numpy; ``f`` is called
    with numpy vectors and its result brought to the host."""
    u = np.asarray(host(u), dtype=np.float64)
    ndim = len(u)
    jac = np.zeros((ndim, ndim))
    for j in range(ndim):
        step = max(1e-6, 1e-6 * abs(u[j]))
        up = u.copy()
        up[j] += step
        um = u.copy()
        um[j] -= step
        jac[:, j] = (host(f(x, up, args)) - host(f(x, um, args))) / (
            2.0 * step)
    return jac


class NewtonSolver:
    """(newton_solver.rs:22)."""

    def __init__(self, ndim: int):
        if ndim < 1:
            raise ValueError("ndim must be >= 1")
        self.ndim = ndim
        self.n_iteration_max = 20
        self.tol_abs = 1e-10
        self.tol_rel = 1e-10
        self.use_numerical_jacobian = False
        self.stats = Stats()

    def set_enable_stats(self, value: bool):
        self.stats.enabled = value
        return self

    def get_stats(self) -> Stats:
        if not self.stats.enabled:
            raise RuntimeError("statistics tracking is disabled")
        return self.stats

    def solve(self, u0, f: Callable, jac: Optional[Callable] = None,
              args=None, x: float = 0.0, device=None):
        """Newton iteration: J du = -F; u += du. ``f(x, u, args) -> F`` and
        ``jac(x, u, args) -> J`` take and return tensors on u's device
        (``jac`` defaults to ``torch.func.jacfwd`` of ``f``; with
        ``use_numerical_jacobian`` the host's central differences call
        ``f`` with u on the device and bring F to the host)."""
        self.stats.reset()
        u = f64(u0, device)
        dev = u.device
        if jac is None and not self.use_numerical_jacobian:
            def jac(xx, uu, aa):
                return torch.func.jacfwd(lambda v: f(xx, v, aa))(uu)
        for _ in range(self.n_iteration_max):
            self.stats.n_iterations += 1
            (r,) = on(f(x, u, args), device=dev)
            self.stats.n_function += 1
            norm = float(torch.sqrt(div(torch.sum(
                (r / (self.tol_abs + self.tol_rel * torch.abs(u))) ** 2),
                float(self.ndim))))
            if norm < 1.0:
                self.stats.error_estimate = norm
                self.stats.stop_sw()
                return u
            self.stats.n_jacobian += 1
            if self.use_numerical_jacobian:
                J = torch.as_tensor(num_jacobian(
                    lambda xx, v, aa: f(xx, torch.as_tensor(v, device=dev),
                                        aa),
                    x, u, args), device=dev)
                self.stats.n_function += 2 * self.ndim
            else:
                (J,) = on(jac(x, u, args), device=dev)
            du = torch.linalg.solve(J, -r)
            u = u + du
        raise RuntimeError("Newton-Raphson method did not converge")
