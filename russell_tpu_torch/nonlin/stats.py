"""Statistics, workspace, and iteration-error control for continuation.

Counterpart of ``russell_tpu.nonlin.stats``, copied: the step logic's
norms are host numpy, as in the reference.

Reference contracts: russell_nonlin/src/{stats.rs, iteration_error.rs}.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from russell_tpu_torch.core.stopwatch import Stopwatch, format_nanoseconds
from russell_tpu_torch.nonlin.config import Config, Status

__all__ = ["Stats", "Workspace", "IterationError"]


@dataclass
class Stats:
    n_function: int = 0
    n_jacobian: int = 0
    n_factor: int = 0
    n_lin_sol: int = 0
    n_steps: int = 0
    n_accepted: int = 0
    n_rejected: int = 0
    n_iteration_total: int = 0
    h_accepted: float = 0.0
    iterations_residuals: List[List[float]] = field(default_factory=list)
    _current_residuals: List[float] = field(default_factory=list)
    nanos_total: int = 0
    sw_step: Stopwatch = field(default_factory=Stopwatch)
    sw_jacobian: Stopwatch = field(default_factory=Stopwatch)
    sw_factor: Stopwatch = field(default_factory=Stopwatch)
    sw_lin_sol: Stopwatch = field(default_factory=Stopwatch)
    sw_total: Stopwatch = field(default_factory=Stopwatch)

    def reset(self):
        self.n_function = 0
        self.n_jacobian = 0
        self.n_factor = 0
        self.n_lin_sol = 0
        self.n_steps = 0
        self.n_accepted = 0
        self.n_rejected = 0
        self.n_iteration_total = 0
        self.h_accepted = 0.0
        self.iterations_residuals = []
        self.sw_total.reset()

    def record_iterations_residuals_start(self):
        self._current_residuals = []

    def record_iterations_residuals_append(self, r: float):
        self._current_residuals.append(r)

    def record_iterations_residuals_stop(self, converged: bool):
        if converged:
            self.iterations_residuals.append(self._current_residuals)

    def stop_sw_step(self):
        self.sw_step.stop()

    def stop_sw_jacobian(self):
        self.sw_jacobian.stop()

    def stop_sw_factor(self):
        self.sw_factor.stop()

    def stop_sw_lin_sol(self):
        self.sw_lin_sol.stop()

    def stop_sw_total(self):
        self.nanos_total = self.sw_total.stop()

    def summary(self) -> str:
        return (f"Number of function evaluations = {self.n_function}\n"
                f"Number of Jacobian evaluations = {self.n_jacobian}\n"
                f"Number of factorizations       = {self.n_factor}\n"
                f"Number of lin sys solutions    = {self.n_lin_sol}\n"
                f"Number of steps                = {self.n_steps}\n"
                f"Number of accepted steps       = {self.n_accepted}\n"
                f"Number of rejected steps       = {self.n_rejected}\n"
                f"Total number of iterations     = {self.n_iteration_total}\n"
                f"Total time                     = "
                f"{format_nanoseconds(self.nanos_total)}")


class IterationError:
    """Residual/delta convergence + divergence tracking
    (iteration_error.rs)."""

    def __init__(self, config: Config, ndim: int):
        self.tol_abs_residual = config.tol_abs_residual
        self.tol_abs_delta = config.tol_abs_delta
        self.tol_rel_delta = config.tol_rel_delta
        self.allowed_delta_max = config.delta_max_allowed
        self.disable_rel = config.disable_rel_delta_analysis
        self.n_iteration_max = config.n_iteration_max
        self.n_cont_residual_divergence_max = \
            config.n_cont_residual_divergence_max
        self.n_cont_delta_divergence_max = config.n_cont_delta_divergence_max
        self.scaling = np.zeros(ndim + 1)
        self.residual_max = 0.0
        self.delta_max = 0.0
        self.delta_rms = 0.0
        self.residual_converged = False
        self.delta_converged = False
        self._reset_flags()

    def _reset_flags(self):
        self.residual_converged = False
        self.residual_diverging = False
        self.delta_converged = False
        self.delta_diverging = False
        self.prev_residual_diverging = False
        self.prev_delta_diverging = False
        self.n_large_delta = 0
        self.n_continued_residual_divergence = 0
        self.n_continued_delta_divergence = 0
        self.residual_max_prev = 0.0
        self.delta_max_prev = 0.0

    def reset(self, u, l: float):
        self._reset_flags()
        u = np.asarray(u)
        n = len(u)
        self.scaling[:n] = self.tol_abs_delta + self.tol_rel_delta * np.abs(u)
        self.scaling[n] = self.tol_abs_delta + self.tol_rel_delta * abs(l)

    def converged(self) -> bool:
        return self.residual_converged or self.delta_converged

    def analyze_residual(self, iteration: int, gg, nn: float) -> bool:
        self.residual_max = max(float(np.max(np.abs(np.asarray(gg)))),
                                abs(nn))
        if not math.isfinite(self.residual_max):
            return True
        self.residual_converged = self.residual_max < self.tol_abs_residual
        self.prev_residual_diverging = self.residual_diverging
        self.residual_diverging = (iteration > 0
                                   and self.residual_max
                                   > self.residual_max_prev)
        if self.prev_residual_diverging and self.residual_diverging:
            self.n_continued_residual_divergence += 1
        self.residual_max_prev = self.residual_max
        return False

    def analyze_delta(self, iteration: int, x) -> bool:
        if self.disable_rel:
            return False
        x = np.asarray(x)
        self.delta_max = float(np.max(np.abs(x)))
        if not math.isfinite(self.delta_max):
            return True
        s = self.scaling[: len(x)]
        self.delta_rms = float(np.sqrt(np.sum((x / s) ** 2) / len(x)))
        self.delta_converged = self.delta_rms <= 1.0
        self.prev_delta_diverging = self.delta_diverging
        self.delta_diverging = (iteration > 0
                                and self.delta_max > self.delta_max_prev)
        if self.prev_delta_diverging and self.delta_diverging:
            self.n_continued_delta_divergence += 1
        self.delta_max_prev = self.delta_max
        return False

    def capture_failures(self, iteration: int) -> Status:
        if self.delta_max > self.allowed_delta_max:
            self.n_large_delta += 1
            return Status.LARGE_DELTA
        if (self.n_continued_residual_divergence
                >= self.n_cont_residual_divergence_max):
            return Status.CONTINUED_RESIDUAL_DIVERGENCE
        if (self.n_continued_delta_divergence
                >= self.n_cont_delta_divergence_max):
            return Status.CONTINUED_DELTA_DIVERGENCE
        if iteration == self.n_iteration_max - 1:
            return Status.REACHED_MAX_ITERATIONS
        return Status.SUCCESS


class Workspace:
    """Shared continuation state (russell_nonlin workspace)."""

    def __init__(self, config: Config, ndim: int):
        self.stats = Stats()
        self.err = IterationError(config, ndim)
        self.u = np.zeros(ndim)
        self.l = 0.0
        self.gg = np.zeros(ndim)
        self.duds = np.zeros(ndim)
        self.dlds = 0.0
        self.h = 0.0
        self.n_iteration = 0
        self.auto = False
        self.target_reached = False
        self.follows_failure = False
        self.follows_rejection = False
        self.n_continued_failure = 0
        self.n_continued_rejection = 0

    def reset_stats_and_flags(self, auto: bool):
        self.stats.reset()
        self.auto = auto
        self.target_reached = False
        self.follows_failure = False
        self.follows_rejection = False
        self.n_continued_failure = 0
        self.n_continued_rejection = 0
