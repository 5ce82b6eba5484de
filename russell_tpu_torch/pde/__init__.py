"""Elliptic-PDE toolkit, in PyTorch.

Counterpart of ``russell_tpu.pde``, which re-designs ``russell_pde``
(reference: russell_pde/src/lib.rs:106-146):
structured grids (uniform + Chebyshev-Gauss-Lobatto), essential/natural
BC handlers, DOF partitioning, finite differences (Fdm1d/2d), spectral
collocation (Spc1d/2d and transfinite-mapped SpcMap2d), Coons-patch
transfinite maps + metrics, and both essential-BC strategies:
system partitioning (SPS) and Lagrange multipliers (LMM). Grids, boundary
conditions, assembly and the right-hand sides stay host numpy, as in the
reference; every solve goes through the port's ``LinSolver`` on the
solver's ``device`` (the card unless the caller names another).
"""

from russell_tpu_torch.pde.enums import Side
from russell_tpu_torch.pde.grid import Grid1d, Grid2d
from russell_tpu_torch.pde.bcs import (EssentialBcs1d, EssentialBcs2d,
                                       NaturalBcs1d, NaturalBcs2d)
from russell_tpu_torch.pde.equation_handler import EquationHandler
from russell_tpu_torch.pde.fdm import Fdm1d, Fdm2d
from russell_tpu_torch.pde.spc import Spc1d, Spc2d
from russell_tpu_torch.pde.spc_map import SpcMap2d
from russell_tpu_torch.pde.transfinite import Transfinite2d, Transfinite3d
from russell_tpu_torch.pde.metrics import Metrics
from russell_tpu_torch.pde import problem_samples

__all__ = [
    "Side", "Grid1d", "Grid2d", "EssentialBcs1d", "EssentialBcs2d",
    "NaturalBcs1d", "NaturalBcs2d", "EquationHandler", "Fdm1d", "Fdm2d",
    "Spc1d", "Spc2d", "SpcMap2d", "Transfinite2d", "Transfinite3d",
    "Metrics", "problem_samples",
]
