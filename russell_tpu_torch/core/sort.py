"""Small-tuple sorting helpers (reference: russell_lab/src/base/sort.rs).

Counterpart of ``russell_tpu.core.sort``, copied: host Python."""

from __future__ import annotations

__all__ = ["sort2", "sort3", "sort4", "argsort2", "argsort3", "argsort4"]


def sort2(a, b):
    """Return (min, max)."""
    return (a, b) if a <= b else (b, a)


def sort3(a, b, c):
    """Return the three values ascending."""
    return tuple(sorted((a, b, c)))


def sort4(a, b, c, d):
    """Return the four values ascending."""
    return tuple(sorted((a, b, c, d)))


def _argsort(vals):
    return tuple(i for i, _ in sorted(enumerate(vals), key=lambda t: t[1]))


def argsort2(a, b):
    return _argsort((a, b))


def argsort3(a, b, c):
    return _argsort((a, b, c))


def argsort4(a, b, c, d):
    return _argsort((a, b, c, d))
