"""Adaptive numerical quadrature.

Reference contract: russell_lab/src/algo/quadrature.rs:74 — configurable
n_gauss in {6, 8, 10, 12, 14}, tolerance, n_iteration_max, Stats; result
matches ~1e-13 on smooth integrands.

Fresh design (not a port of the Fortran GAUS8 lineage the reference
wraps): globally-adaptive bisection with Gauss-Legendre n and 2n panels
as the error estimator — the standard interval-halving strategy; a
max-heap on panel error gives the same robustness class.

Counterpart of ``russell_tpu.algo.quadrature``, copied: host Python and
numpy, as in the reference (each point is a call of the user's Python
callback ``f(x, args)``), on the port's Legendre point and weight sets.
"""

from __future__ import annotations

import heapq

import numpy as np

from russell_tpu_torch.algo.stats import Stats
from russell_tpu_torch.math.legendre import (legendre_gauss_points,
                                       legendre_gauss_weights)

__all__ = ["Quadrature"]

EPS = 2.220446049250313e-16


class Quadrature:
    def __init__(self):
        self.n_iteration_max = 300
        self.tolerance = 1e-10
        self.n_gauss = 10
        self.stats = Stats()

    def _validate(self):
        if self.n_iteration_max < 2:
            raise ValueError("n_iteration_max must be >= 2")
        if self.tolerance < 10.0 * EPS:
            raise ValueError("the tolerance must be >= 10.0 * EPSILON")
        if self.n_gauss not in (6, 8, 10, 12, 14):
            raise ValueError("n_gauss must be 6, 8, 10, 12, or 14")

    def set_enable_stats(self, value: bool):
        self.stats.enabled = value
        return self

    def get_stats(self) -> Stats:
        if not self.stats.enabled:
            raise RuntimeError("statistics tracking is disabled")
        return self.stats

    def integrate(self, a: float, b: float, f, args=None) -> float:
        """I = int_a^b f(x) dx (quadrature.rs:201)."""
        if abs(b - a) < 10.0 * EPS:
            raise ValueError("the lower and upper bounds must be different "
                             "from each other")
        self._validate()
        self.stats.reset()
        n = self.n_gauss
        xg_lo = legendre_gauss_points(n - 1)
        wg_lo = legendre_gauss_weights(n - 1)
        xg_hi = legendre_gauss_points(2 * n - 1)
        wg_hi = legendre_gauss_weights(2 * n - 1)

        def panel(lo, hi):
            mid = 0.5 * (lo + hi)
            half = 0.5 * (hi - lo)
            y_lo = np.array([float(f(mid + half * t, args)) for t in xg_lo])
            y_hi = np.array([float(f(mid + half * t, args)) for t in xg_hi])
            self.stats.n_function += len(xg_lo) + len(xg_hi)
            i_lo = half * float(wg_lo @ y_lo)
            i_hi = half * float(wg_hi @ y_hi)
            return i_hi, abs(i_hi - i_lo)

        val, err = panel(a, b)
        heap = [(-err, a, b, val)]
        total = val
        total_err = err
        for _ in range(self.n_iteration_max):
            self.stats.n_iterations += 1
            if total_err <= self.tolerance * max(1.0, abs(total)):
                self.stats.error_estimate = total_err
                self.stats.stop_sw()
                return total
            neg_err, lo, hi, v = heapq.heappop(heap)
            mid = 0.5 * (lo + hi)
            v1, e1 = panel(lo, mid)
            v2, e2 = panel(mid, hi)
            total += v1 + v2 - v
            total_err += e1 + e2 + neg_err  # neg_err = -err_old
            heapq.heappush(heap, (-e1, lo, mid, v1))
            heapq.heappush(heap, (-e2, mid, hi, v2))
        raise RuntimeError("quadrature did not converge")
