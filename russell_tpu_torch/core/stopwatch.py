"""Nanosecond stopwatch + human formatting.

Reference contract: russell_lab/src/base/stopwatch.rs:63 and
format_nanoseconds (base/formatters.rs:60). Used by solver stats
(StatsLinSol.time_nanoseconds / time_human twins).
"""

from __future__ import annotations

import time

__all__ = ["Stopwatch", "format_nanoseconds"]


def format_nanoseconds(ns: int) -> str:
    """Render nanoseconds as a human-readable duration.

    Matches the spirit of russell_lab base/formatters.rs:60: picks the
    largest sensible unit chain (e.g. ``1m2.3s``, ``123.45ms``, ``800ns``).
    """
    ns = int(ns)
    if ns == 0:
        return "0ns"
    sign = "-" if ns < 0 else ""
    ns = abs(ns)
    if ns < 1_000:
        return f"{sign}{ns}ns"
    if ns < 1_000_000:
        return f"{sign}{ns / 1_000:.6g}µs"
    if ns < 1_000_000_000:
        return f"{sign}{ns / 1_000_000:.6g}ms"
    seconds = ns / 1_000_000_000
    if seconds < 60:
        return f"{sign}{seconds:.6g}s"
    minutes = int(seconds // 60)
    rem = seconds - minutes * 60
    if minutes < 60:
        return f"{sign}{minutes}m{rem:.6g}s"
    hours = minutes // 60
    minutes -= hours * 60
    return f"{sign}{hours}h{minutes}m{rem:.6g}s"


class Stopwatch:
    """Monotonic nanosecond stopwatch.

    >>> sw = Stopwatch()           # starts immediately
    >>> ns = sw.stop()             # elapsed ns, accumulates
    >>> sw.reset(); sw.stop()      # restart
    """

    def __init__(self) -> None:
        self._t0 = time.perf_counter_ns()
        self._elapsed = 0

    def reset(self) -> None:
        self._t0 = time.perf_counter_ns()
        self._elapsed = 0

    def stop(self) -> int:
        """Stop and return total elapsed nanoseconds since last reset."""
        now = time.perf_counter_ns()
        self._elapsed = now - self._t0
        return self._elapsed

    def elapsed(self) -> int:
        return self._elapsed

    def __str__(self) -> str:
        return format_nanoseconds(self._elapsed)
