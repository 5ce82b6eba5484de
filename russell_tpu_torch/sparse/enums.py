"""Sparse-solver enums (reference: russell_sparse/src/enums.rs:5-282).

The reference's ``Genie`` selects an external backend {Mumps, Umfpack, Cudss};
here it selects one of the native factorization paths. The values are those
of ``russell_tpu.sparse.enums``; of the paths, the port has SPLU so far
(``sparse/factor.py`` raises for the others). ``Sym`` carries
symmetric-storage conventions through assembly and SpMV exactly as in the
reference (enums.rs:27).
"""

from __future__ import annotations

import enum

__all__ = ["Genie", "Sym", "MMsym", "Ordering", "Scaling"]


class Genie(enum.Enum):
    """Solver-kernel selector (native registry replacing enums.rs:5-20).

    - AUTO:   pick DENSE for small n, BANDED when the reordered bandwidth is
              small relative to n, else SPLU.
    - DENSE:  partial-pivoting dense LU (best for n <~ 2048)
    - BANDED: block-tridiagonal LU after bandwidth-reducing (RCM) ordering;
              static pivoting + iterative refinement
    - SPLU:   general sparse left-looking LU, host symbolic + device numeric
    """

    AUTO = "auto"
    DENSE = "dense"
    BANDED = "banded"
    SPLU = "splu"
    # regular-grid nested-dissection multifrontal: batched congruent
    # dense fronts, every hot op a large batched GEMM (needs a grid hint)
    GRIDMF = "gridmf"
    # general-matrix nested-dissection multifrontal: manufactured
    # congruence by (depth, e, r) size-class bucketing — the fast path
    # for irregular patterns (no grid hint needed)
    GENMF = "genmf"

    @staticmethod
    def from_name(name: str) -> "Genie":
        return Genie(name.lower())


class Sym(enum.Enum):
    """Symmetric-storage flag (russell_sparse enums.rs:27)."""

    NO = "no"
    YES_FULL = "yes_full"
    YES_LOWER = "yes_lower"
    YES_UPPER = "yes_upper"

    def triangular(self) -> bool:
        return self in (Sym.YES_LOWER, Sym.YES_UPPER)

    def is_sym(self) -> bool:
        return self != Sym.NO


class MMsym(enum.Enum):
    """Handling of MatrixMarket symmetric storage (russell_sparse enums.rs:45).

    - LEAVE_AS_LOWER: keep standard MM lower-triangular storage (Sym.YES_LOWER)
    - SWAP_TO_UPPER:  mirror to upper-triangular storage (Sym.YES_UPPER)
    - MAKE_IT_FULL:   duplicate off-diagonal entries into full storage
    """

    LEAVE_AS_LOWER = "leave_as_lower"
    SWAP_TO_UPPER = "swap_to_upper"
    MAKE_IT_FULL = "make_it_full"


class Ordering(enum.Enum):
    """Fill-reducing / bandwidth-reducing ordering (enums.rs:71-158).

    The reference exposes backend-specific orderings (Amd/Amf/Colamd/Metis/...).
    Native equivalents: RCM (bandwidth minimization, feeds BANDED), AMD
    (fill-in minimization, feeds SPLU), NATURAL (identity).
    """

    AUTO = "auto"
    NATURAL = "natural"
    RCM = "rcm"
    AMD = "amd"
    METIS = "metis"  # mapped to the native nested dissection ("nd")


class Scaling(enum.Enum):
    """Row/column equilibration strategy (enums.rs:159)."""

    AUTO = "auto"
    NO = "no"
    ROW_COL_ITER = "row_col_iter"  # iterative row/col inf-norm equilibration
    MAX = "max"  # single-pass max-abs row then col scaling
