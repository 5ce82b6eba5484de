"""Text histogram (reference: russell_stat/src/histogram.rs:62).

Counterpart of ``russell_tpu.stat.histogram``: host numpy code, as in the
reference; ``count`` takes a tensor on any device (copied to the host).
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.core._place import host

__all__ = ["Histogram"]


class Histogram:
    """Counts values into station-delimited bins and renders a text chart."""

    def __init__(self, stations):
        stations = np.asarray(host(stations), dtype=np.float64)
        if stations.size < 2:
            raise ValueError("at least 2 stations are required")
        if np.any(np.diff(stations) <= 0):
            raise ValueError("stations must be sorted ascending")
        self.stations = stations
        self.counts = np.zeros(stations.size - 1, dtype=np.int64)
        self.bar_char = "#"
        self.bar_max_len = 60
        self.precision = 2

    def count(self, data):
        """Accumulates counts into [s_i, s_{i+1}) bins; values outside the
        stations are ignored (histogram.rs:98)."""
        data = np.asarray(host(data), dtype=np.float64)
        idx = np.searchsorted(self.stations, data, side="right") - 1
        ok = (idx >= 0) & (idx < len(self.counts)) & (
            data < self.stations[-1])
        np.add.at(self.counts, idx[ok], 1)

    def reset(self):
        self.counts[:] = 0

    def get_counts(self) -> np.ndarray:
        return self.counts

    def set_bar_char(self, c: str) -> "Histogram":
        self.bar_char = c
        return self

    def set_bar_max_len(self, n: int) -> "Histogram":
        self.bar_max_len = n
        return self

    def set_scientific_fmt_precision(self, p: int) -> "Histogram":
        self.precision = p
        return self

    def __str__(self) -> str:
        cmax = max(int(np.max(self.counts)), 1)
        scale = min(1.0, self.bar_max_len / cmax)
        lines = []
        p = self.precision
        for i, c in enumerate(self.counts):
            lo = f"{self.stations[i]:.{p}e}"
            hi = f"{self.stations[i + 1]:.{p}e}"
            bar = self.bar_char * int(round(c * scale))
            lines.append(f"[{lo},{hi}) | {c:>6} {bar}")
        return "\n".join(lines)

    def draw(self) -> str:
        return str(self)
