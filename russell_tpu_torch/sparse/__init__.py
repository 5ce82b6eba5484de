"""Sparse matrices and the SPLU direct solver, in PyTorch.

Counterpart of ``russell_tpu.sparse``. So far: the COO triplet matrix, the host
orderings, SPLU (host plan + numeric left-looking scan whose block-pair
products and row gathers are CUDA kernels on the card) and the SPLU path
of ``factor``. The other solver paths are later slices (ROADMAP.md).
"""

from russell_tpu_torch.sparse.enums import Genie, Sym, MMsym, Ordering, Scaling
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.lin_solver import LinSolParams

__all__ = ["Genie", "Sym", "MMsym", "Ordering", "Scaling", "CooMatrix",
           "LinSolParams"]
