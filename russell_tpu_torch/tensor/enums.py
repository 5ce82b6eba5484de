"""Mandel basis selector (reference: russell_tensor/src/enums.rs:5).

Counterpart of ``russell_tpu.tensor.enums``."""

from __future__ import annotations

import enum

__all__ = ["Mandel"]


class Mandel(enum.Enum):
    """General 9D / Symmetric 6D / Symmetric2D 4D."""

    GENERAL = 9
    SYMMETRIC = 6
    SYMMETRIC_2D = 4

    def dim(self) -> int:
        return self.value

    def symmetric(self) -> bool:
        return self != Mandel.GENERAL

    def two_dim(self) -> bool:
        return self == Mandel.SYMMETRIC_2D

    @staticmethod
    def new(n: int) -> "Mandel":
        return Mandel(n)
