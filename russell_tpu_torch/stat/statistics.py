"""Descriptive statistics (reference: russell_stat/src/{statistics.rs,
quantile.rs:52, quartiles.rs:42, inter_quartile_range.rs:49,
outliers.rs:53}).

Counterpart of ``russell_tpu.stat.statistics``: host numpy code, as in the
reference. Each function takes a tensor on any device (copied to the host)
or anything ``np.asarray`` takes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from russell_tpu_torch.core._place import host

__all__ = ["Statistics", "quantile", "quartiles", "inter_quartile_range",
           "outliers"]


def _f64(x) -> np.ndarray:
    return np.asarray(host(x), dtype=np.float64)


class Statistics:
    """min/max/mean/std_dev with the corrected two-pass algorithm
    (statistics.rs:4)."""

    def __init__(self, x):
        x = _f64(x)
        if x.size == 0:
            self.min = self.max = self.mean = self.std_dev = 0.0
            return
        if x.size == 1:
            self.min = self.max = self.mean = float(x[0])
            self.std_dev = 0.0
            return
        self.min = float(np.min(x))
        self.max = float(np.max(x))
        self.mean = float(np.mean(x))
        n = x.size
        d = x - self.mean
        corrector = float(np.sum(d)) ** 2 / n
        variance = (float(np.sum(d * d)) - corrector) / (n - 1)
        self.std_dev = float(np.sqrt(variance))

    def __str__(self):
        return (f"min = {self.min}\nmax = {self.max}\nmean = {self.mean}\n"
                f"std_dev = {self.std_dev}")


def quantile(data, q: float) -> float:
    """Linear-interpolated quantile over SORTED data (NumPy convention;
    quantile.rs:52)."""
    data = _f64(data)
    if data.size == 0:
        raise ValueError("Input data slice must not be empty")
    if q < 0.0 or q > 1.0:
        raise ValueError("Quantile q must be in the range [0.0, 1.0]")
    idx = q * (data.size - 1)
    lo = int(np.floor(idx))
    hi = int(np.ceil(idx))
    frac = idx - lo
    return float(data[lo] + frac * (data[hi] - data[lo]))


def quartiles(data) -> Tuple[float, float, float]:
    """(Q1, Q2, Q3); sorts a copy (quartiles.rs:42)."""
    d = np.sort(_f64(data))
    return quantile(d, 0.25), quantile(d, 0.5), quantile(d, 0.75)


def inter_quartile_range(data) -> float:
    """Q3 - Q1 (inter_quartile_range.rs:49)."""
    q1, _, q3 = quartiles(data)
    return q3 - q1


def outliers(data) -> List[Tuple[int, float]]:
    """1.5-IQR rule; returns (original_index, value) pairs sorted by value,
    ties in index order (outliers.rs:53)."""
    arr = _f64(data)
    order = np.argsort(arr, kind="stable")
    q1, _, q3 = quartiles(arr)
    iqr = q3 - q1
    lo = q1 - 1.5 * iqr
    hi = q3 + 1.5 * iqr
    v = arr[order]
    out = (v < lo) | (v > hi)
    return list(zip(order[out].tolist(), v[out].tolist()))
