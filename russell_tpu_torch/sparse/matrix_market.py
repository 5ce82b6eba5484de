"""MatrixMarket coordinate-format I/O.

Counterpart of ``russell_tpu.sparse.matrix_market`` (host numpy). Reference
contract: russell_sparse/src/read_matrix_market.rs:346 and
write_matrix_market.rs —

- ``read_matrix_market(path, handling)`` returns ``(coo_real, coo_complex)``
  with exactly one of the pair set, mirroring the Rust
  ``(Option<CooMatrix>, Option<ComplexCooMatrix>)``
- header must be ``%%MatrixMarket matrix coordinate {real|complex} {general|symmetric|hermitian}``
- symmetric data must be stored lower-triangular; handling maps to Sym flags
  via the MMsym enum (enums.rs:45)
- parse errors (wrong dims, too many/few lines, rectangular symmetric, ...)
  raise ValueError with messages analogous to the reference's StrError cases
  (the ``bad_*.mtx`` fixtures)
- the writer emits ``.mtx`` or vismatrix ``.smat`` depending on extension
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import MMsym, Sym

__all__ = ["read_matrix_market", "write_matrix_market"]


def read_matrix_market(full_path: str, handling: MMsym = MMsym.LEAVE_AS_LOWER):
    """Read a .mtx coordinate file -> (CooMatrix|None, CooMatrix|None).

    First element is the real matrix, second the complex one; exactly one is
    not None (read_matrix_market.rs:346).
    """
    with open(full_path, "r") as fh:
        lines = fh.readlines()

    # -- header ---------------------------------------------------------------
    idx = 0
    header = None
    while idx < len(lines):
        line = lines[idx].strip()
        idx += 1
        if line:
            header = line
            break
    if header is None:
        raise ValueError("file is empty")
    parts = header.lower().split()
    if (
        len(parts) != 5
        or parts[0] != "%%matrixmarket"
        or parts[1] != "matrix"
        or parts[2] != "coordinate"
    ):
        raise ValueError("after %%MatrixMarket, the first option must be \"matrix\" "
                         "and the second option must be \"coordinate\"")
    if parts[3] not in ("real", "complex"):
        raise ValueError("after %%MatrixMarket, the third option must be either "
                         "\"real\" or \"complex\"")
    complex_values = parts[3] == "complex"
    if parts[4] not in ("general", "symmetric", "hermitian"):
        raise ValueError("after %%MatrixMarket, the fourth option must be one of "
                         "\"general\", \"symmetric\", or \"hermitian\"")
    symmetric = parts[4] in ("symmetric", "hermitian")
    if parts[4] == "hermitian" and not complex_values:
        raise ValueError("hermitian matrices must be complex")

    # -- dimensions -----------------------------------------------------------
    dims = None
    while idx < len(lines):
        line = lines[idx].strip()
        idx += 1
        if not line or line.startswith("%"):
            continue
        dims = line.split()
        break
    if dims is None:
        raise ValueError("cannot find the line with dimensions")
    if len(dims) != 3:
        raise ValueError("the dimensions line must have 3 values: nrow ncol nnz")
    try:
        nrow, ncol, nnz = (int(d) for d in dims)
    except ValueError:
        raise ValueError("cannot parse the dimensions") from None
    if nrow < 1 or ncol < 1 or nnz < 1:
        raise ValueError("dimensions must be positive")
    if symmetric and nrow != ncol:
        raise ValueError("symmetric matrices must be square")

    # -- data -----------------------------------------------------------------
    want = 4 if complex_values else 3
    ii = np.zeros(nnz, dtype=np.int64)
    jj = np.zeros(nnz, dtype=np.int64)
    vv = np.zeros(nnz, dtype=np.complex128 if complex_values else np.float64)
    count = 0
    for line in lines[idx:]:
        line = line.strip()
        if not line or line.startswith("%"):
            continue
        toks = line.split()
        if len(toks) != want:
            raise ValueError(f"each data line must have {want} values")
        if count >= nnz:
            raise ValueError("there are more lines than specified")
        try:
            i = int(toks[0]) - 1
            j = int(toks[1]) - 1
            if complex_values:
                v = float(toks[2]) + 1j * float(toks[3])
            else:
                v = float(toks[2])
        except ValueError:
            raise ValueError("cannot parse the values") from None
        if not (0 <= i < nrow) or not (0 <= j < ncol):
            raise ValueError("found invalid indices")
        if symmetric and j > i:
            raise ValueError("the lower triangle of symmetric matrices must be "
                             "stored in the MatrixMarket file")
        ii[count], jj[count], vv[count] = i, j, v
        count += 1
    if count != nnz:
        raise ValueError("there are less lines than specified")

    # -- symmetry handling ------------------------------------------------------
    if symmetric:
        if handling == MMsym.LEAVE_AS_LOWER:
            sym = Sym.YES_LOWER
        elif handling == MMsym.SWAP_TO_UPPER:
            ii, jj = jj, ii
            sym = Sym.YES_UPPER
        else:  # MAKE_IT_FULL: mirror off-diagonal entries
            off = ii != jj
            mirrored_v = np.conj(vv[off]) if parts[4] == "hermitian" else vv[off]
            ii, jj, vv = (
                np.concatenate([ii, jj[off]]),
                np.concatenate([jj, ii[off]]),
                np.concatenate([vv, mirrored_v]),
            )
            sym = Sym.YES_FULL
    else:
        sym = Sym.NO

    if not complex_values:
        vv = vv.real
    coo = CooMatrix.from_arrays(nrow, ncol, ii, jj, vv, sym)
    if complex_values:
        return None, coo
    return coo, None


def write_matrix_market(mat, full_path: str, vismatrix: bool = False) -> None:
    """Write COO/CSR/CSC to .mtx, or to vismatrix .smat when ``vismatrix=True``
    or the path ends in ``.smat`` (write_matrix_market.rs)."""
    if hasattr(mat, "triplets"):
        ii, jj, vv = mat.triplets()
        nrow, ncol, sym = mat.nrow, mat.ncol, mat.sym
    else:
        dense = mat.to_dense() if hasattr(mat, "to_dense") else np.asarray(mat)
        ii, jj = np.nonzero(dense)
        vv = dense[ii, jj]
        nrow, ncol = dense.shape
        sym = getattr(mat, "sym", Sym.NO)
        if sym.triangular():
            keep = jj <= ii if sym == Sym.YES_LOWER else jj >= ii
            ii, jj, vv = ii[keep], jj[keep], vv[keep]

    is_complex = np.asarray(vv).dtype.kind == "c"
    if vismatrix or full_path.endswith(".smat"):
        with open(full_path, "w") as fh:
            fh.write(f"{nrow} {ncol} {len(vv)}\n")
            for i, j, v in zip(ii, jj, vv):
                if is_complex:
                    fh.write(f"{i} {j} {v.real:.15g} {v.imag:.15g}\n")
                else:
                    fh.write(f"{i} {j} {v:.15g}\n")
        return

    kind = "complex" if is_complex else "real"
    shape = "symmetric" if sym.triangular() else "general"
    with open(full_path, "w") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate {kind} {shape}\n")
        fh.write(f"{nrow} {ncol} {len(vv)}\n")
        for i, j, v in zip(ii, jj, vv):
            if is_complex:
                fh.write(f"{i + 1} {j + 1} {v.real:.15g} {v.imag:.15g}\n")
            else:
                fh.write(f"{i + 1} {j + 1} {v:.15g}\n")
