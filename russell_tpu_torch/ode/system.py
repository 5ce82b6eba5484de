"""ODE/DAE system definition (reference: russell_ode/src/system.rs:64-233).

Counterpart of ``russell_tpu.ode.system``. The rhs and Jacobian are plain
functions of torch tensors, computed on the device of the state ``y``:

- ``function(x, y, args) -> f`` — the rhs.
- ``set_jacobian((ii, jj), fn)`` — analytical sparse Jacobian:
  ``fn(x, y, args) -> vals`` aligned with the frozen (ii, jj) structure.
  This slice of the port needs analytic Jacobians only; the autodiff and
  numerical paths of the reference package are a later slice.
- ``set_mass(coo)`` — constant mass matrix M (DAE; Radau5 only).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import Sym

__all__ = ["System", "NoArgs"]

NoArgs = type(None)


class System:
    """Defines M dy/dx = f(x, y) with optional sparse Jacobian structure."""

    def __init__(self, ndim: int, function: Callable,
                 symmetric: Sym = Sym.NO):
        if ndim < 1:
            raise ValueError("ndim must be >= 1")
        self.ndim = int(ndim)
        self.function = function
        self.symmetric = symmetric
        self.jacobian: Optional[Callable] = None
        self.jac_structure: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.mass: Optional[CooMatrix] = None
        # optional structure hint (nr, nc, s) for grid-stencil Jacobians
        # (species-major layout var = k*nr*nc + r*nc + c); read by the
        # GRIDMF path, which the port does not have yet
        self.grid: Optional[Tuple[int, int, int]] = None

    # -- jacobian ------------------------------------------------------------

    def set_jacobian(self, structure, fn: Callable) -> None:
        """Analytical Jacobian: ``fn(x, y, args) -> vals`` for the fixed
        (ii, jj) ``structure`` (system.rs:198; the α scaling of the
        reference's callback is applied by the steppers)."""
        ii, jj = structure
        ii = np.asarray(ii, dtype=np.int64)
        jj = np.asarray(jj, dtype=np.int64)
        if len(ii) != len(jj):
            raise ValueError("structure arrays must have equal length")
        self.jac_structure = (ii, jj)
        self.jacobian = fn

    def jac_values_fn(self, use_numerical: bool = False):
        """Returns ((ii, jj), fn(x, y, args) -> vals) for the analytical
        Jacobian."""
        if use_numerical or self.jacobian is None:
            raise NotImplementedError(
                "the port has analytic Jacobians only so far; autodiff and "
                "numerical Jacobians are a later slice (ROADMAP.md)")
        return self.jac_structure, self.jacobian

    # -- mass ----------------------------------------------------------------

    def set_mass(self, mass: CooMatrix) -> None:
        """Constant mass matrix for DAEs (system.rs:233)."""
        if mass.nrow != self.ndim or mass.ncol != self.ndim:
            raise ValueError("mass matrix must be ndim x ndim")
        self.mass = mass
