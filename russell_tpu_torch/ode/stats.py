"""Solver statistics and stepping workspace.

The counter names are part of the reference's test contract
(russell_ode/src/stats.rs:7; tests assert exact counts against Hairer's
Fortran logs, e.g. tests/test_radau5_van_der_pol.rs:28-56).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from russell_tpu_torch.core.stopwatch import Stopwatch, format_nanoseconds
from russell_tpu_torch.ode.enums import Method

__all__ = ["Stats", "Workspace"]


@dataclass
class Stats:
    """Counters + stopwatches (stats.rs:7,165)."""

    method: str = ""
    n_function: int = 0
    n_jacobian: int = 0
    n_factor: int = 0
    n_lin_sol: int = 0
    n_steps: int = 0
    n_accepted: int = 0
    n_rejected: int = 0
    n_iterations: int = 0
    n_iterations_max: int = 0
    h_accepted: float = 0.0
    # nanosecond timers
    nanos_step_max: int = 0
    nanos_jacobian_max: int = 0
    nanos_factor_max: int = 0
    nanos_lin_sol_max: int = 0
    nanos_total: int = 0
    sw_step: Stopwatch = field(default_factory=Stopwatch)
    sw_jacobian: Stopwatch = field(default_factory=Stopwatch)
    sw_factor: Stopwatch = field(default_factory=Stopwatch)
    sw_lin_sol: Stopwatch = field(default_factory=Stopwatch)
    sw_total: Stopwatch = field(default_factory=Stopwatch)

    def reset(self, h: float):
        self.n_function = 0
        self.n_jacobian = 0
        self.n_factor = 0
        self.n_lin_sol = 0
        self.n_steps = 0
        self.n_accepted = 0
        self.n_rejected = 0
        self.n_iterations = 0
        self.n_iterations_max = 0
        self.h_accepted = h
        self.nanos_step_max = 0
        self.nanos_jacobian_max = 0
        self.nanos_factor_max = 0
        self.nanos_lin_sol_max = 0
        self.nanos_total = 0
        self.sw_total.reset()

    def update_n_iterations_max(self):
        self.n_iterations_max = max(self.n_iterations_max, self.n_iterations)

    def stop_sw_step(self):
        self.nanos_step_max = max(self.nanos_step_max, self.sw_step.stop())

    def stop_sw_jacobian(self):
        self.nanos_jacobian_max = max(self.nanos_jacobian_max,
                                      self.sw_jacobian.stop())

    def stop_sw_factor(self):
        self.nanos_factor_max = max(self.nanos_factor_max, self.sw_factor.stop())

    def stop_sw_lin_sol(self):
        self.nanos_lin_sol_max = max(self.nanos_lin_sol_max,
                                     self.sw_lin_sol.stop())

    def stop_sw_total(self):
        self.nanos_total = self.sw_total.stop()

    def summary(self) -> str:
        """Human-readable summary (stats.rs:165)."""
        lines = [
            f"{self.method}: stats",
            f"Number of function evaluations   = {self.n_function}",
            f"Number of Jacobian evaluations   = {self.n_jacobian}",
            f"Number of factorizations         = {self.n_factor}",
            f"Number of lin sys solutions      = {self.n_lin_sol}",
            f"Number of performed steps        = {self.n_steps}",
            f"Number of accepted steps         = {self.n_accepted}",
            f"Number of rejected steps         = {self.n_rejected}",
            f"Number of iterations (maximum)   = {self.n_iterations_max}",
            f"Number of iterations (last step) = {self.n_iterations}",
            f"Last accepted/suggested stepsize = {self.h_accepted}",
            f"Max time spent on a step         = "
            f"{format_nanoseconds(self.nanos_step_max)}",
            f"Max time spent on the Jacobian   = "
            f"{format_nanoseconds(self.nanos_jacobian_max)}",
            f"Max time spent on factorization  = "
            f"{format_nanoseconds(self.nanos_factor_max)}",
            f"Max time spent on lin solution   = "
            f"{format_nanoseconds(self.nanos_lin_sol_max)}",
            f"Total time                       = "
            f"{format_nanoseconds(self.nanos_total)}",
        ]
        return "\n".join(lines)

    def __str__(self):
        return self.summary()


class Workspace:
    """Shared stepping state (workspace.rs:4)."""

    def __init__(self, method: Method):
        self.stats = Stats(method=method.name)
        self.follows_reject_step = False
        self.iterations_diverging = False
        self.h_multiplier_diverging = 1.0
        self.h_prev = 0.0
        self.h_new = 0.0
        self.rel_error_prev = 0.0
        self.rel_error = 0.0
        self.stiff_x_first_detect = math.inf
        self.stiff_h_times_rho = 0.0
        self.stiff_n_detection_no = 0
        self.stiff_n_detection_yes = 0
        self.stiff_detected = False

    def reset(self, h: float, rel_error_prev_min: float):
        self.stats.reset(h)
        self.follows_reject_step = False
        self.iterations_diverging = False
        self.h_multiplier_diverging = 1.0
        self.h_prev = h
        self.h_new = h
        self.rel_error_prev = rel_error_prev_min
        self.rel_error = 0.0
        self.stiff_x_first_detect = math.inf
        self.stiff_h_times_rho = 0.0
        self.stiff_n_detection_no = 0
        self.stiff_n_detection_yes = 0
        self.stiff_detected = False
