"""Sparse matrices, the SPLU direct solver and the BSR products, in PyTorch.

Counterpart of ``russell_tpu.sparse``. So far: the COO matrix, CSR/CSC
(host structure, values on a device), the samples, MatrixMarket I/O,
VerifyLinSys, the host orderings, SPLU (host plan + numeric left-looking
scan whose block-pair products and row gathers are CUDA kernels on the
card), the SPLU path of ``factor``, and BSR SpMV/SpMM and block SpGEMM
(``kernels``, three CUDA kernels on the card). The other solver paths are
later slices (ROADMAP.md).
"""

from russell_tpu_torch.sparse.enums import Genie, Sym, MMsym, Ordering, Scaling
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.csr import CsrMatrix
from russell_tpu_torch.sparse.csc import CscMatrix
from russell_tpu_torch.sparse.matrix_market import (read_matrix_market,
                                                    write_matrix_market)
from russell_tpu_torch.sparse.verify import VerifyLinSys
from russell_tpu_torch.sparse.lin_solver import LinSolParams
from russell_tpu_torch.sparse.kernels import (BsrMatrix, bsr_from_coo,
                                              bsr_matvec, bsr_matmat,
                                              spgemm_plan, spgemm)
from russell_tpu_torch.sparse import samples

__all__ = ["Genie", "Sym", "MMsym", "Ordering", "Scaling", "CooMatrix",
           "CsrMatrix", "CscMatrix", "read_matrix_market",
           "write_matrix_market", "VerifyLinSys", "LinSolParams", "BsrMatrix",
           "bsr_from_coo", "bsr_matvec", "bsr_matmat", "spgemm_plan",
           "spgemm", "samples"]
