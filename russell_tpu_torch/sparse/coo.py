"""COO (triplet) sparse matrix assembly.

Counterpart of ``russell_tpu.sparse.coo`` (reference contract:
russell_sparse/src/coo_matrix.rs, NumCooMatrix):
- fixed capacity ``max_nnz``; ``put`` appends triplets, duplicates allowed and
  summed on conversion (FEM assembly; lib.rs:23, csc_matrix.rs:337)
- a ``Sym`` flag records triangular storage for symmetric matrices
- ``mat_vec_mul`` / ``mat_t_vec_mul`` honor the mirror for triangular storage
  (coo_matrix.rs:547,708)
- ``assign``/``add`` build alpha*A (+ beta*B) reusing the structure
  (coo_matrix.rs:738,779)
- complex extensions ``assign_real``/``add_real`` build (a+bi)*M - J from real
  pieces (complex_coo_matrix.rs)

Host-side numpy by design, as in the reference: assembly is sequential. The
device-side formats are built from it (``CsrMatrix.from_coo``,
``bsr_from_coo``).
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.sparse.enums import Sym

__all__ = ["CooMatrix"]


class CooMatrix:
    """Triplet matrix with russell-compatible semantics (dtype float64 or
    complex128)."""

    def __init__(self, nrow: int, ncol: int, max_nnz: int, sym: Sym = Sym.NO,
                 dtype=np.float64):
        if nrow < 1 or ncol < 1:
            raise ValueError("nrow and ncol must be >= 1")
        if max_nnz < 1:
            raise ValueError("max_nnz must be >= 1")
        if sym.triangular() and nrow != ncol:
            raise ValueError("symmetric matrices must be square")
        self.nrow = int(nrow)
        self.ncol = int(ncol)
        self.max_nnz = int(max_nnz)
        self.sym = sym
        self.dtype = np.dtype(dtype)
        self.nnz = 0
        self.indices_i = np.zeros(max_nnz, dtype=np.int64)
        self.indices_j = np.zeros(max_nnz, dtype=np.int64)
        self.values = np.zeros(max_nnz, dtype=self.dtype)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(cls, nrow, ncol, ii, jj, vv, sym: Sym = Sym.NO):
        ii = np.asarray(ii, dtype=np.int64)
        jj = np.asarray(jj, dtype=np.int64)
        vv = np.asarray(vv)
        if not (len(ii) == len(jj) == len(vv)):
            raise ValueError("i/j/v arrays must have equal length")
        m = cls(nrow, ncol, max(len(vv), 1), sym, dtype=vv.dtype if vv.dtype.kind in "fc" else np.float64)
        if len(vv):
            if ii.min() < 0 or ii.max() >= nrow or jj.min() < 0 or jj.max() >= ncol:
                raise ValueError("index out of range")
            _check_triangle(ii, jj, sym)
            m.indices_i[: len(ii)] = ii
            m.indices_j[: len(jj)] = jj
            m.values[: len(vv)] = vv.astype(m.dtype)
            m.nnz = len(vv)
        return m

    @classmethod
    def from_dense(cls, a, sym: Sym = Sym.NO, zero_tol: float = 0.0):
        a = np.asarray(a)
        nrow, ncol = a.shape
        ii, jj = np.nonzero(np.abs(a) > zero_tol)
        if sym == Sym.YES_LOWER:
            keep = ii >= jj
            ii, jj = ii[keep], jj[keep]
        elif sym == Sym.YES_UPPER:
            keep = ii <= jj
            ii, jj = ii[keep], jj[keep]
        return cls.from_arrays(nrow, ncol, ii, jj, a[ii, jj], sym)

    def put(self, i: int, j: int, value) -> None:
        """Append a triplet (duplicates allowed; coo_matrix.rs:324)."""
        if not (0 <= i < self.nrow):
            raise ValueError("index i is out of range")
        if not (0 <= j < self.ncol):
            raise ValueError("index j is out of range")
        if self.sym == Sym.YES_LOWER and j > i:
            raise ValueError("j > i is incorrect for lower triangular storage")
        if self.sym == Sym.YES_UPPER and j < i:
            raise ValueError("j < i is incorrect for upper triangular storage")
        if self.nnz >= self.max_nnz:
            raise ValueError("max number of items has been reached")
        self.indices_i[self.nnz] = i
        self.indices_j[self.nnz] = j
        self.values[self.nnz] = value
        self.nnz += 1

    def put_lagrange_block(self, offset_i: int, offset_j: int, coefficients) -> None:
        """Append a Lagrange-multiplier coupling block: for each k, puts
        (offset_i + k, offset_j) and its transpose (coo_matrix.rs:823)."""
        for k, c in enumerate(np.asarray(coefficients).ravel()):
            self.put(offset_i + k, offset_j, c)
            self.put(offset_j, offset_i + k, c)

    def reset(self) -> None:
        """Forget all triplets, keep capacity (coo_matrix.rs:388)."""
        self.nnz = 0

    # -- structure-preserving value assignment (coo_matrix.rs:738,779) ------

    def assign(self, alpha, other: "CooMatrix") -> None:
        """self := alpha * other (copies structure + scaled values)."""
        self._require_same_shape(other)
        self.nnz = other.nnz
        self.indices_i[: other.nnz] = other.indices_i[: other.nnz]
        self.indices_j[: other.nnz] = other.indices_j[: other.nnz]
        self.values[: other.nnz] = alpha * other.values[: other.nnz]

    def add(self, alpha, a: "CooMatrix", beta, b: "CooMatrix") -> None:
        """self := alpha*a + beta*b by concatenating triplets."""
        self._require_same_shape(a)
        self._require_same_shape(b)
        total = a.nnz + b.nnz
        if total > self.max_nnz:
            raise ValueError("max number of items has been reached")
        self.nnz = total
        self.indices_i[: a.nnz] = a.indices_i[: a.nnz]
        self.indices_j[: a.nnz] = a.indices_j[: a.nnz]
        self.values[: a.nnz] = alpha * a.values[: a.nnz]
        self.indices_i[a.nnz : total] = b.indices_i[: b.nnz]
        self.indices_j[a.nnz : total] = b.indices_j[: b.nnz]
        self.values[a.nnz : total] = beta * b.values[: b.nnz]

    def assign_real(self, alpha: complex, beta: complex, other: "CooMatrix") -> None:
        """self := (alpha + i beta) * other_real (complex_coo_matrix.rs)."""
        if self.dtype.kind != "c":
            raise ValueError("assign_real requires a complex matrix")
        self._require_same_shape(other)
        self.nnz = other.nnz
        self.indices_i[: other.nnz] = other.indices_i[: other.nnz]
        self.indices_j[: other.nnz] = other.indices_j[: other.nnz]
        self.values[: other.nnz] = (alpha + 1j * beta) * other.values[: other.nnz]

    def add_real(self, alpha: complex, beta: complex, a: "CooMatrix", gamma, b: "CooMatrix") -> None:
        """self := (alpha + i beta)*a + gamma*b with real a, b."""
        if self.dtype.kind != "c":
            raise ValueError("add_real requires a complex matrix")
        total = a.nnz + b.nnz
        if total > self.max_nnz:
            raise ValueError("max number of items has been reached")
        self.nnz = total
        self.indices_i[: a.nnz] = a.indices_i[: a.nnz]
        self.indices_j[: a.nnz] = a.indices_j[: a.nnz]
        self.values[: a.nnz] = (alpha + 1j * beta) * a.values[: a.nnz]
        self.indices_i[a.nnz : total] = b.indices_i[: b.nnz]
        self.indices_j[a.nnz : total] = b.indices_j[: b.nnz]
        self.values[a.nnz : total] = gamma * b.values[: b.nnz]

    # -- linear algebra ------------------------------------------------------

    def mat_vec_mul(self, u):
        """v = A @ u honoring triangular mirror (coo_matrix.rs:547)."""
        u = np.asarray(u)
        if u.shape[0] != self.ncol:
            raise ValueError("u vector is incompatible")
        ii = self.indices_i[: self.nnz]
        jj = self.indices_j[: self.nnz]
        vv = self.values[: self.nnz]
        out_dtype = np.result_type(self.dtype, u.dtype)
        v = np.zeros(self.nrow, dtype=out_dtype)
        np.add.at(v, ii, vv * u[jj])
        if self.sym.triangular():
            off = ii != jj
            np.add.at(v, jj[off], vv[off] * u[ii[off]])
        return v

    def mat_t_vec_mul(self, u):
        """v = A^T @ u (coo_matrix.rs:708)."""
        u = np.asarray(u)
        if u.shape[0] != self.nrow:
            raise ValueError("u vector is incompatible")
        ii = self.indices_i[: self.nnz]
        jj = self.indices_j[: self.nnz]
        vv = self.values[: self.nnz]
        out_dtype = np.result_type(self.dtype, u.dtype)
        v = np.zeros(self.ncol, dtype=out_dtype)
        np.add.at(v, jj, vv * u[ii])
        if self.sym.triangular():
            off = ii != jj
            np.add.at(v, ii[off], vv[off] * u[jj[off]])
        return v

    # -- getters -------------------------------------------------------------

    def as_dense(self) -> np.ndarray:
        a = np.zeros((self.nrow, self.ncol), dtype=self.dtype)
        ii = self.indices_i[: self.nnz]
        jj = self.indices_j[: self.nnz]
        vv = self.values[: self.nnz]
        np.add.at(a, (ii, jj), vv)
        if self.sym.triangular():
            off = ii != jj
            np.add.at(a, (jj[off], ii[off]), vv[off])
        return a

    def get_info(self):
        """(nrow, ncol, nnz, sym) — coo_matrix.rs getters."""
        return self.nrow, self.ncol, self.nnz, self.sym

    def triplets(self):
        """(i, j, v) views of the active triplets."""
        return (
            self.indices_i[: self.nnz],
            self.indices_j[: self.nnz],
            self.values[: self.nnz],
        )

    def _require_same_shape(self, other: "CooMatrix") -> None:
        if (self.nrow, self.ncol) != (other.nrow, other.ncol):
            raise ValueError("matrices must have the same dimensions")

    def __repr__(self) -> str:
        return (
            f"CooMatrix(nrow={self.nrow}, ncol={self.ncol}, nnz={self.nnz}, "
            f"sym={self.sym.name}, dtype={self.dtype})"
        )


def _check_triangle(ii, jj, sym: Sym) -> None:
    if sym == Sym.YES_LOWER and (jj > ii).any():
        raise ValueError("found j > i for lower triangular storage")
    if sym == Sym.YES_UPPER and (jj < ii).any():
        raise ValueError("found j < i for upper triangular storage")
