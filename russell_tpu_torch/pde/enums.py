"""PDE enums (reference: russell_pde/src/enums.rs:3).

Counterpart of ``russell_tpu.pde.enums``, copied (host numpy, as in
the reference).
"""

from __future__ import annotations

import enum

__all__ = ["Side"]


class Side(enum.Enum):
    XMIN = 0
    XMAX = 1
    YMIN = 2
    YMAX = 3

    @staticmethod
    def from_index(index: int) -> "Side":
        return Side(index)
