"""Sparse matrices, the SPLU direct solver and the BSR products, in PyTorch.

Counterpart of ``russell_tpu.sparse``: the COO matrix, CSR/CSC (host
structure, values on a device), the samples, MatrixMarket I/O,
VerifyLinSys, the host orderings, the LinSolver with its params and stats
over every path of ``factor`` — DENSE, BANDED (sequential scan or block
cyclic reduction, ``bcr``), SPLU (host plan + numeric left-looking scan
whose block-pair products and row gathers are CUDA kernels on the card),
GRIDMF and GENMF (multifrontal, their pivot-block inverses the ``gj_inv``
CUDA kernel on the card) — the numerical Jacobian, and BSR SpMV/SpMM and
block SpGEMM (``kernels``, three CUDA kernels on the card).
"""

from russell_tpu_torch.sparse.enums import Genie, Sym, MMsym, Ordering, Scaling
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.csr import CsrMatrix
from russell_tpu_torch.sparse.csc import CscMatrix
from russell_tpu_torch.sparse.matrix_market import (read_matrix_market,
                                                    write_matrix_market)
from russell_tpu_torch.sparse.verify import VerifyLinSys
from russell_tpu_torch.sparse.lin_solver import (LinSolParams, LinSolver,
                                                 StatsLinSol)
from russell_tpu_torch.sparse.kernels import (BsrMatrix, bsr_from_coo,
                                              bsr_matvec, bsr_matmat,
                                              spgemm_plan, spgemm)
from russell_tpu_torch.sparse import samples

__all__ = ["Genie", "Sym", "MMsym", "Ordering", "Scaling", "CooMatrix",
           "CsrMatrix", "CscMatrix", "read_matrix_market",
           "write_matrix_market", "VerifyLinSys", "LinSolParams", "LinSolver",
           "StatsLinSol", "BsrMatrix",
           "bsr_from_coo", "bsr_matvec", "bsr_matmat", "spgemm_plan",
           "spgemm", "samples"]
