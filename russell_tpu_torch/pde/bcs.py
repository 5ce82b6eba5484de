"""Boundary-condition handlers.

Counterpart of ``russell_tpu.pde.bcs``, copied (host numpy, as in
the reference).

Reference contracts: russell_pde/src/{essential_bcs_1d.rs:29,
essential_bcs_2d.rs, natural_bcs_1d.rs, natural_bcs_2d.rs} — per-Side
value functions for Dirichlet (essential) and flux (natural) conditions,
periodic flags, and side-consistency validation.
"""

from __future__ import annotations

from typing import Callable, List

from russell_tpu_torch.pde.enums import Side

__all__ = ["EssentialBcs1d", "EssentialBcs2d", "NaturalBcs1d",
           "NaturalBcs2d"]

_ZERO1 = lambda x: 0.0
_ZERO2 = lambda x, y: 0.0


class _Bcs:
    def __init__(self, n_sides: int, zero):
        self.sides = [False] * n_sides
        self.functions = [zero] * n_sides
        self.periodic_along_x = False
        self.periodic_along_y = False

    def set(self, side: Side, f: Callable):
        idx = side.value
        if idx >= len(self.sides):
            raise ValueError(f"side {side} is invalid for this dimension")
        self.sides[idx] = True
        self.functions[idx] = f
        return self

    def enabled(self, side: Side) -> bool:
        return self.sides[side.value]


class EssentialBcs1d(_Bcs):
    """(essential_bcs_1d.rs)."""

    def __init__(self):
        super().__init__(2, _ZERO1)

    def set_periodic(self, along_x: bool):
        self.periodic_along_x = along_x

    def set_homogeneous(self):
        self.set(Side.XMIN, _ZERO1)
        self.set(Side.XMAX, _ZERO1)
        return self

    def get_nodes(self, grid) -> List[int]:
        nodes = []
        for idx in range(2):
            if self.sides[idx]:
                for m in grid.get_nodes_on_side(Side.from_index(idx)):
                    if m not in nodes:
                        nodes.append(m)
        return nodes

    def validate(self, nbcs: "NaturalBcs1d"):
        for idx in range(2):
            if self.sides[idx] and nbcs.sides[idx]:
                raise ValueError("essential and natural BCs must not be set "
                                 "on the same side")
        if self.periodic_along_x and (any(self.sides) or any(nbcs.sides)):
            raise ValueError("periodic BCs must not be combined with other "
                             "BCs on the same direction")


class EssentialBcs2d(_Bcs):
    """(essential_bcs_2d.rs)."""

    def __init__(self):
        super().__init__(4, _ZERO2)

    def set_periodic(self, along_x: bool, along_y: bool):
        self.periodic_along_x = along_x
        self.periodic_along_y = along_y

    def set_homogeneous(self):
        for s in Side:
            self.set(s, _ZERO2)
        return self

    def get_nodes(self, grid) -> List[int]:
        nodes = []
        seen = set()
        for idx in range(4):
            if self.sides[idx]:
                for m in grid.get_nodes_on_side(Side.from_index(idx)):
                    if m not in seen:
                        seen.add(m)
                        nodes.append(m)
        return nodes

    def validate(self, nbcs: "NaturalBcs2d"):
        for idx in range(4):
            if self.sides[idx] and nbcs.sides[idx]:
                raise ValueError("essential and natural BCs must not be set "
                                 "on the same side")
            if self.periodic_along_x and idx in (0, 1) and (
                    self.sides[idx] or nbcs.sides[idx]):
                raise ValueError("periodic-x must not be combined with "
                                 "Xmin/Xmax BCs")
            if self.periodic_along_y and idx in (2, 3) and (
                    self.sides[idx] or nbcs.sides[idx]):
                raise ValueError("periodic-y must not be combined with "
                                 "Ymin/Ymax BCs")


class NaturalBcs1d(_Bcs):
    """(natural_bcs_1d.rs)."""

    def __init__(self):
        super().__init__(2, _ZERO1)


class NaturalBcs2d(_Bcs):
    """(natural_bcs_2d.rs)."""

    def __init__(self):
        super().__init__(4, _ZERO2)

    def enabled_ij(self, i: int, j: int, grid) -> bool:
        """Whether node (i,j) lies on a flux-enabled side
        (natural_bcs_2d.rs:226)."""
        if i == 0:
            return self.sides[0]
        if i == grid.nx() - 1:
            return self.sides[1]
        if j == 0:
            return self.sides[2]
        if j == grid.ny() - 1:
            return self.sides[3]
        return False
