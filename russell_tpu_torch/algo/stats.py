"""Algorithm counters (reference: russell_lab/src/algo/stats.rs:7).

Counterpart of ``russell_tpu.algo.stats``, copied: host integers."""

from __future__ import annotations

from dataclasses import dataclass, field

from russell_tpu_torch.core.stopwatch import Stopwatch, format_nanoseconds

__all__ = ["Stats"]


@dataclass
class Stats:
    n_function: int = 0
    n_jacobian: int = 0
    n_iterations: int = 0
    error_estimate: float = 0.0
    nanos: int = 0
    enabled: bool = False
    sw: Stopwatch = field(default_factory=Stopwatch)

    def reset(self):
        self.n_function = 0
        self.n_jacobian = 0
        self.n_iterations = 0
        self.error_estimate = 0.0
        self.nanos = 0
        self.sw.reset()

    def stop_sw(self):
        self.nanos = self.sw.stop()

    def summary(self) -> str:
        return (f"Number of function evaluations = {self.n_function}\n"
                f"Number of Jacobian evaluations = {self.n_jacobian}\n"
                f"Number of iterations           = {self.n_iterations}\n"
                f"Error estimate                 = {self.error_estimate}\n"
                f"Total computation time         = "
                f"{format_nanoseconds(self.nanos)}")

    def __str__(self):
        return self.summary()
