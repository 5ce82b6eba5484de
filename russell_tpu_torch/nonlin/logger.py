"""Table-formatted step logger (reference: russell_nonlin/src/logger.rs:
header:53, step:91, footer:173); a copy of ``russell_tpu.nonlin.logger``."""

from __future__ import annotations

import sys

__all__ = ["Logger"]


class Logger:
    def __init__(self, config):
        self.config = config
        self._lines = []

    def _emit(self, s: str):
        self._lines.append(s)
        if self.config.verbose or self.config.verbose_header_footer:
            print(s, file=sys.stdout)

    def header(self):
        name = self.config.method.name.capitalize()
        self._emit(f"{'':-^64}")
        self._emit(f"{name + ' continuation':^64}")
        self._emit(f"{'':-^64}")
        self._emit(f"{'step':>6}{'h':>16}{'lambda':>16}")

    def step(self, h: float, l: float, last: bool):
        tag = "last" if last else ""
        self._emit(f"{tag:>6}{h:>16.6e}{l:>16.6e}")

    def iteration(self, it: int, err):
        if self.config.verbose_iterations:
            self._emit(f"    it={it:>3}  resid={err.residual_max:.3e}  "
                       f"delta_rms={err.delta_rms:.3e}")

    def did_not_converge(self):
        self._emit("    iterations did not converge")

    def footer(self, stats, status):
        self._emit(f"{'':-^64}")
        self._emit(f"status = {status.name}")
        self._emit(stats.summary())

    def lines(self):
        return self._lines
