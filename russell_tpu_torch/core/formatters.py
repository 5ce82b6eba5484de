"""Number formatters for diffing against Fortran outputs.

Reference contract: russell_lab/src/base/formatters.rs:154-187
(``format_scientific`` and ``format_fortran`` == ES23.15).

Counterpart of ``russell_tpu.core.formatters``, copied: host Python, as in
the reference (``vec_fmt_scientific`` brings a tensor to the host).
"""

from __future__ import annotations

import math

from russell_tpu_torch.core._place import host

__all__ = ["format_scientific", "format_fortran", "vec_fmt_scientific"]


def format_scientific(num: float, width: int, precision: int) -> str:
    """Format ``num`` like Fortran ``ESw.p``: ``d.dddE±XX`` right-padded.

    >>> format_scientific(3723000.0, 23, 15)
    '  3.723000000000000E+06'
    """
    num = float(num)
    if not math.isfinite(num):
        return f"{num:>{width}}"
    s = f"{num:.{precision}e}"
    mantissa, exp = s.split("e")
    sign = "-" if exp.startswith("-") else "+"
    digits = exp.lstrip("+-")
    return f"{mantissa}E{sign}{int(digits):02d}".rjust(width)


def format_fortran(num: float) -> str:
    """Fortran ES23.15 (russell_lab base/formatters.rs:185)."""
    return format_scientific(num, 23, 15)


def vec_fmt_scientific(v, precision: int = 6) -> str:
    """Pretty-print a vector with scientific entries, one per line block."""
    vv = host(v).ravel()
    width = precision + 9
    inner = "".join(format_scientific(float(x), width, precision) for x in vv)
    return f"┌{' ' * (width * len(vv) + 1)}┐\n│{inner} │\n└{' ' * (width * len(vv) + 1)}┘"
