"""ODE/DAE system definition (reference: russell_ode/src/system.rs:64-233).

Counterpart of ``russell_tpu.ode.system``. The rhs and Jacobian are plain
functions of torch tensors, computed on the device of the state ``y``:

- ``function(x, y, args) -> f`` — the rhs.
- Jacobian options, in order of preference:
  1. ``set_jacobian((ii, jj), fn)`` — analytical sparse Jacobian:
     ``fn(x, y, args) -> vals`` aligned with the frozen (ii, jj) structure.
  2. autodiff (default when no jacobian is given and
     ``use_numerical_jacobian`` is False): ``torch.func.jacfwd`` of the
     rhs, exact to machine precision. The rhs must then be functional: no
     in-place writes on ``y``, no ``.item()``, no numpy.
  3. numerical forward differences when
     ``ParamsNewton.use_numerical_jacobian`` is set, one rhs evaluation
     per column, batched with ``torch.func.vmap`` (the steppers count
     ``n_function += ndim`` for it, as the reference does).
- ``set_mass(coo)`` — constant mass matrix M (DAE; Radau5 only).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

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
        # (species-major layout var = k*nr*nc + r*nc + c); unlocks the
        # GRIDMF multifrontal path
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

    def dense_structure(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full ndim x ndim structure (used by autodiff/numerical paths)."""
        n = self.ndim
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        return ii.ravel(), jj.ravel()

    @property
    def jac_nnz(self) -> int:
        if self.jac_structure is not None:
            return len(self.jac_structure[0])
        return self.ndim * self.ndim

    def jac_values_fn(self, use_numerical: bool = False):
        """Returns ((ii, jj), fn(x, y, args) -> vals) choosing between the
        analytical, autodiff, and numerical paths."""
        if self.jacobian is not None and not use_numerical:
            return self.jac_structure, self.jacobian

        ii, jj = self.dense_structure()
        f = self.function
        if not use_numerical:

            def ad_vals(x, y, args):
                jac = torch.func.jacfwd(lambda yy: f(x, yy, args))(y)
                return jac.reshape(-1)

            return (ii, jj), ad_vals

        def num_vals(x, y, args):
            # forward differences, one rhs eval per column
            # (russell_sparse/src/numerical_jacobian.rs:129 semantics)
            fy = f(x, y, args)
            eps = float(np.sqrt(torch.finfo(y.dtype).eps))
            dy = eps * torch.clamp_min(torch.abs(y), 1e-5)
            yp = y + torch.diag(dy)  # row j: y with dy[j] added at j
            fp = torch.func.vmap(lambda yy: f(x, yy, args))(yp)
            cols = (fp - fy) / dy[:, None]  # (ncol, ndim)
            return cols.T.reshape(-1)

        return (ii, jj), num_vals

    # -- lanes (solve_batch) -------------------------------------------------

    def lane_function(self):
        """``F(x (B,), y (B, ndim)) -> (B, ndim)``: the rhs of B
        independent lanes (``torch.func.vmap``; the rhs must then be
        functional, as for autodiff)."""
        f = self.function
        return torch.func.vmap(lambda x, y: f(x, y, None))

    def lane_jacobian(self, jac_fn):
        """``J(x (B,), y (B, ndim)) -> (B, nnz)`` for the values function
        ``jac_fn`` of ``jac_values_fn``, over B lanes."""
        return torch.func.vmap(lambda x, y: jac_fn(x, y, None))

    # -- mass ----------------------------------------------------------------

    def set_mass(self, mass: CooMatrix) -> None:
        """Constant mass matrix for DAEs (system.rs:233)."""
        if mass.nrow != self.ndim or mass.ncol != self.ndim:
            raise ValueError("mass matrix must be ndim x ndim")
        self.mass = mass
