"""1-D and 2-D structured grids.

Counterpart of ``russell_tpu.pde.grid``, copied (host numpy, as in
the reference).

Reference contract: russell_pde/src/grid_1d.rs:56 and grid_2d.rs:88 —
uniform or Chebyshev-Gauss-Lobatto point sets, m = i + j·nx numbering,
boundary queries, and side node lists.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from russell_tpu_torch.math.chebyshev import chebyshev_lobatto_points
from russell_tpu_torch.pde.enums import Side

__all__ = ["Grid1d", "Grid2d"]


class Grid1d:
    """(grid_1d.rs)."""

    def __init__(self, xx):
        xx = np.asarray(xx, dtype=np.float64)
        if len(xx) < 2:
            raise ValueError("at least two points are required")
        if np.any(np.diff(xx) <= 0):
            raise ValueError("the x coordinates must be strictly increasing")
        self.xx = xx

    @classmethod
    def new_uniform(cls, xmin: float, xmax: float, nx: int) -> "Grid1d":
        if nx < 2:
            raise ValueError("nx must be >= 2")
        if xmax <= xmin:
            raise ValueError("xmax must be > xmin")
        return cls(np.linspace(xmin, xmax, nx))

    @classmethod
    def new_chebyshev_gauss_lobatto(cls, nx: int) -> "Grid1d":
        if nx < 2:
            raise ValueError("nx must be >= 2")
        return cls(np.asarray(chebyshev_lobatto_points(nx - 1)))

    def nx(self) -> int:
        return len(self.xx)

    def size(self) -> int:
        return len(self.xx)

    def is_xmin(self, m: int) -> bool:
        return m == 0

    def is_xmax(self, m: int) -> bool:
        return m == self.nx() - 1

    def on_boundary(self, m: int) -> bool:
        return m == 0 or m == self.nx() - 1

    def get_nodes_on_side(self, side: Side):
        if side == Side.XMIN:
            return [0]
        if side == Side.XMAX:
            return [self.nx() - 1]
        raise ValueError("1D grids only have Xmin/Xmax sides")

    def get_boundary_nodes(self):
        return [0], [self.nx() - 1]

    def get_dx(self) -> Optional[float]:
        d = np.diff(self.xx)
        if np.allclose(d, d[0], rtol=1e-12, atol=1e-14):
            return float(d[0])
        return None

    def coord(self, m: int) -> float:
        return float(self.xx[m])

    def for_each_coord(self, f):
        for m, x in enumerate(self.xx):
            f(m, float(x))


class Grid2d:
    """(grid_2d.rs; m = i + j nx)."""

    def __init__(self, xx, yy, cgl: bool = False):
        xx = np.asarray(xx, dtype=np.float64)
        yy = np.asarray(yy, dtype=np.float64)
        if len(xx) < 2 or len(yy) < 2:
            raise ValueError("at least two points are required per direction")
        if np.any(np.diff(xx) <= 0) or np.any(np.diff(yy) <= 0):
            raise ValueError("the coordinates must be strictly increasing")
        self.xx = xx
        self.yy = yy
        self._cgl = cgl

    @classmethod
    def new_uniform(cls, xmin, xmax, ymin, ymax, nx: int, ny: int) -> "Grid2d":
        if nx < 2 or ny < 2:
            raise ValueError("nx and ny must be >= 2")
        if xmax <= xmin or ymax <= ymin:
            raise ValueError("max coordinates must be > min coordinates")
        return cls(np.linspace(xmin, xmax, nx), np.linspace(ymin, ymax, ny))

    @classmethod
    def new_chebyshev_gauss_lobatto(cls, nx: int, ny: int) -> "Grid2d":
        if nx < 2 or ny < 2:
            raise ValueError("nx and ny must be >= 2")
        return cls(np.asarray(chebyshev_lobatto_points(nx - 1)),
                   np.asarray(chebyshev_lobatto_points(ny - 1)), cgl=True)

    def is_chebyshev_gauss_lobatto(self) -> bool:
        return self._cgl

    def xmin(self) -> float:
        return float(self.xx[0])

    def xmax(self) -> float:
        return float(self.xx[-1])

    def ymin(self) -> float:
        return float(self.yy[0])

    def ymax(self) -> float:
        return float(self.yy[-1])

    def nx(self) -> int:
        return len(self.xx)

    def ny(self) -> int:
        return len(self.yy)

    def size(self) -> int:
        return self.nx() * self.ny()

    def get_m(self, i: int, j: int) -> int:
        return i + j * self.nx()

    def get_ij(self, m: int) -> Tuple[int, int]:
        return m % self.nx(), m // self.nx()

    def is_xmin(self, m: int) -> bool:
        return m % self.nx() == 0

    def is_xmax(self, m: int) -> bool:
        return m % self.nx() == self.nx() - 1

    def is_ymin(self, m: int) -> bool:
        return m // self.nx() == 0

    def is_ymax(self, m: int) -> bool:
        return m // self.nx() == self.ny() - 1

    def on_boundary(self, m: int) -> bool:
        return (self.is_xmin(m) or self.is_xmax(m) or self.is_ymin(m)
                or self.is_ymax(m))

    def is_corner(self, m: int) -> bool:
        return (self.is_xmin(m) or self.is_xmax(m)) and \
            (self.is_ymin(m) or self.is_ymax(m))

    def get_nodes_on_side(self, side: Side):
        nx, ny = self.nx(), self.ny()
        if side == Side.XMIN:
            return [self.get_m(0, j) for j in range(ny)]
        if side == Side.XMAX:
            return [self.get_m(nx - 1, j) for j in range(ny)]
        if side == Side.YMIN:
            return [self.get_m(i, 0) for i in range(nx)]
        return [self.get_m(i, ny - 1) for i in range(nx)]

    def get_boundary_nodes(self):
        return tuple(self.get_nodes_on_side(Side.from_index(k))
                     for k in range(4))

    def get_dx_dy(self) -> Optional[Tuple[float, float]]:
        dx = np.diff(self.xx)
        dy = np.diff(self.yy)
        if (np.allclose(dx, dx[0], rtol=1e-12, atol=1e-14)
                and np.allclose(dy, dy[0], rtol=1e-12, atol=1e-14)):
            return float(dx[0]), float(dy[0])
        return None

    def coord(self, m: int) -> Tuple[float, float]:
        i, j = self.get_ij(m)
        return float(self.xx[i]), float(self.yy[j])

    def for_each_coord(self, f):
        nx = self.nx()
        for j, y in enumerate(self.yy):
            for i, x in enumerate(self.xx):
                f(i + j * nx, float(x), float(y))

    def coords_arrays(self):
        """(x[m], y[m]) arrays over all nodes (vectorized helper)."""
        X, Y = np.meshgrid(self.xx, self.yy)  # Y rows = j
        return X.ravel(), Y.ravel()
