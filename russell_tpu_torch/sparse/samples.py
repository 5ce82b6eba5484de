"""Canonical sample matrices for solver tests.

Counterpart of ``russell_tpu.sparse.samples`` (names and matrices as in
russell_sparse/src/samples.rs): small matrices with known determinants,
the public vendor-documentation examples (UMFPACK QuickStart, Intel MKL
sparse examples) and the large generators (``laplacian_2d``,
``laplacian_3d``, ``irregular_geometric``). Each small sample returns
``(coo, csc, csr, det)``; its CSC and CSR values live on ``device``. The
generators return a host ``CooMatrix``.
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.csc import CscMatrix
from russell_tpu_torch.sparse.csr import CsrMatrix
from russell_tpu_torch.sparse.enums import Sym

__all__ = [
    "tiny_1x1", "complex_tiny_1x1",
    "positive_definite_3x3_lower", "positive_definite_3x3_upper",
    "positive_definite_3x3_full",
    "complex_symmetric_3x3_lower", "complex_symmetric_3x3_full",
    "lower_symmetric_5x5",
    "unsymmetric_3x3",
    "umfpack_unsymmetric_5x5", "umfpack_complex_unsymmetric_5x5",
    "mkl_unsymmetric_5x5",
    "block_unsymmetric_5x5",
    "mkl_positive_definite_5x5_lower", "mkl_positive_definite_5x5_upper",
    "mkl_symmetric_5x5_lower", "mkl_symmetric_5x5_upper", "mkl_symmetric_5x5_full",
    "rectangular_1x2", "rectangular_1x7", "rectangular_7x1", "rectangular_3x4",
    "complex_rectangular_4x3",
    "laplacian_2d", "laplacian_3d", "irregular_geometric",
]


def _pack(device, dense, sym: Sym = Sym.NO):
    dense = np.asarray(dense)
    coo = CooMatrix.from_dense(dense, sym)
    csc = CscMatrix.from_coo(coo, device)
    csr = CsrMatrix.from_coo(coo, device)
    if dense.shape[0] == dense.shape[1]:
        det = np.linalg.det(dense if not sym.triangular() else coo.as_dense())
    else:
        det = 0.0
    return coo, csc, csr, det


def tiny_1x1(device="cuda"):
    return _pack(device, [[0.123]])


def complex_tiny_1x1(device="cuda"):
    return _pack(device, np.array([[0.123 + 0.456j]]))


_PD3 = np.array([
    [9.0, 1.5, 6.0],
    [1.5, 0.5, 0.0],
    [6.0, 0.0, 12.0],
])


def positive_definite_3x3_lower(device="cuda"):
    return _pack(device, np.tril(_PD3), Sym.YES_LOWER)


def positive_definite_3x3_upper(device="cuda"):
    return _pack(device, np.triu(_PD3), Sym.YES_UPPER)


def positive_definite_3x3_full(device="cuda"):
    return _pack(device, _PD3, Sym.YES_FULL)


_CSYM3 = np.array([
    [2.0 + 1.0j, -1.0 - 1.0j, 0.0],
    [-1.0 - 1.0j, 2.0 + 2.0j, -1.0 + 0.5j],
    [0.0, -1.0 + 0.5j, 2.0 - 1.0j],
])


def complex_symmetric_3x3_lower(device="cuda"):
    return _pack(device, np.tril(_CSYM3), Sym.YES_LOWER)


def complex_symmetric_3x3_full(device="cuda"):
    return _pack(device, _CSYM3, Sym.YES_FULL)


_SYM5 = np.array([
    [2.0, 1.0, 1.0, 3.0, 2.0],
    [1.0, 2.0, 2.0, 1.0, 1.0],
    [1.0, 2.0, 9.0, 1.0, 5.0],
    [3.0, 1.0, 1.0, 7.0, 1.0],
    [2.0, 1.0, 5.0, 1.0, 8.0],
])


def lower_symmetric_5x5(device="cuda"):
    return _pack(device, np.tril(_SYM5), Sym.YES_LOWER)


def unsymmetric_3x3(device="cuda"):
    return _pack(device, [
        [1.0, 2.0, 3.0],
        [4.0, 5.0, 6.0],
        [7.0, 8.0, 10.0],
    ])


# UMFPACK QuickStart example (public; umfpack_di_demo):
# A x = b with x = [1,2,3,4,5], b = [8,45,-3,3,19]
_UMF5 = np.array([
    [2.0, 3.0, 0.0, 0.0, 0.0],
    [3.0, 0.0, 4.0, 0.0, 6.0],
    [0.0, -1.0, -3.0, 2.0, 0.0],
    [0.0, 0.0, 1.0, 0.0, 0.0],
    [0.0, 4.0, 2.0, 0.0, 1.0],
])


def umfpack_unsymmetric_5x5(device="cuda"):
    return _pack(device, _UMF5)


def umfpack_complex_unsymmetric_5x5(device="cuda"):
    a = _UMF5.astype(np.complex128).copy()
    a[0, 0] = 2.0 + 1.0j
    a[2, 3] = 2.0 - 1.0j
    return _pack(device, a)


# Intel MKL sparse example matrix (public docs)
_MKL5 = np.array([
    [1.0, -1.0, 0.0, -3.0, 0.0],
    [-2.0, 5.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 4.0, 6.0, 4.0],
    [-4.0, 0.0, 2.0, 7.0, 0.0],
    [0.0, 8.0, 0.0, 0.0, -5.0],
])


def mkl_unsymmetric_5x5(device="cuda"):
    return _pack(device, _MKL5)


def block_unsymmetric_5x5(device="cuda"):
    return _pack(device, [
        [1.0, 2.0, 0.0, 0.0, 0.0],
        [3.0, 4.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 5.0, 6.0, 0.0],
        [0.0, 0.0, 7.0, 8.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 9.0],
    ])


# Intel MKL PARDISO SPD example (public docs)
_MKLPD5 = np.array([
    [9.0, 1.5, 6.0, 0.75, 3.0],
    [1.5, 0.5, 0.0, 0.0, 0.0],
    [6.0, 0.0, 12.0, 0.0, 0.0],
    [0.75, 0.0, 0.0, 0.625, 0.0],
    [3.0, 0.0, 0.0, 0.0, 16.0],
])


def mkl_positive_definite_5x5_lower(device="cuda"):
    return _pack(device, np.tril(_MKLPD5), Sym.YES_LOWER)


def mkl_positive_definite_5x5_upper(device="cuda"):
    return _pack(device, np.triu(_MKLPD5), Sym.YES_UPPER)


_MKLSYM5 = np.array([
    [1.0, -1.0, 0.0, -3.0, 0.0],
    [-1.0, 5.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 4.0, 6.0, 4.0],
    [-3.0, 0.0, 6.0, 7.0, 0.0],
    [0.0, 0.0, 4.0, 0.0, -5.0],
])
_MKLSYM5 = (_MKLSYM5 + _MKLSYM5.T) / 2.0


def mkl_symmetric_5x5_lower(device="cuda"):
    return _pack(device, np.tril(_MKLSYM5), Sym.YES_LOWER)


def mkl_symmetric_5x5_upper(device="cuda"):
    return _pack(device, np.triu(_MKLSYM5), Sym.YES_UPPER)


def mkl_symmetric_5x5_full(device="cuda"):
    return _pack(device, _MKLSYM5, Sym.YES_FULL)


def rectangular_1x2(device="cuda"):
    return _pack(device, [[10.0, 20.0]])


def rectangular_1x7(device="cuda"):
    return _pack(device, [[1.0, 0.0, 3.0, 0.0, 5.0, 0.0, 7.0]])


def rectangular_7x1(device="cuda"):
    return _pack(device, [[1.0], [0.0], [3.0], [0.0], [5.0], [0.0], [7.0]])


def rectangular_3x4(device="cuda"):
    return _pack(device, [
        [5.0, -2.0, 0.0, 1.0],
        [10.0, -4.0, 0.0, 2.0],
        [15.0, -6.0, 0.0, 3.0],
    ])


def complex_rectangular_4x3(device="cuda"):
    return _pack(device, np.array([
        [4.0 + 4.0j, 0.0, 2.0 + 2.0j],
        [0.0, 1.0, 3.0 + 3.0j],
        [0.0, 5.0 + 5.0j, 1.0 + 1.0j],
        [1.0, 0.0, 0.0],
    ]))


def laplacian_2d(npoint: int, kx: float = 1.0, ky: float = 1.0) -> CooMatrix:
    """5-point negative Laplacian on an npoint x npoint unit-square grid.

    The classic banded test operator (mirrors the FDM molecule of
    russell_pde/src/fdm_2d.rs:900 and the Jacobian structure of the
    brusselator PDE benchmark, russell_ode/src/samples.rs:497). Assembled
    vectorized (no Python loops) for large npoint.
    """
    n = npoint * npoint
    h = 1.0 / (npoint - 1) if npoint > 1 else 1.0
    cx = kx / (h * h)
    cy = ky / (h * h)
    idx = np.arange(n, dtype=np.int64)
    i = idx // npoint
    j = idx % npoint
    ii = [idx]
    jj = [idx]
    vv = [np.full(n, 2.0 * (cx + cy))]
    west = j > 0
    ii.append(idx[west]); jj.append(idx[west] - 1); vv.append(np.full(west.sum(), -cx))
    east = j < npoint - 1
    ii.append(idx[east]); jj.append(idx[east] + 1); vv.append(np.full(east.sum(), -cx))
    south = i > 0
    ii.append(idx[south]); jj.append(idx[south] - npoint); vv.append(np.full(south.sum(), -cy))
    north = i < npoint - 1
    ii.append(idx[north]); jj.append(idx[north] + npoint); vv.append(np.full(north.sum(), -cy))
    return CooMatrix.from_arrays(
        n, n, np.concatenate(ii), np.concatenate(jj), np.concatenate(vv))


def irregular_geometric(n: int, seed: int = 0, avg_degree: float = 8.0,
                        dom: float = 1.0) -> CooMatrix:
    """Random-geometric irregular sparse matrix (Raj1/ASIC_680k stand-in).

    ``n`` uniform points in the unit square, edges within the radius that
    yields ``avg_degree`` neighbors on average: degrees are Poisson-
    distributed (irregular), vertex labels carry NO banded or grid
    structure, but the graph has the O(sqrt(n)) separators typical of the
    reference's circuit/FEM benchmark class
    (russell_sparse/data/logs/Raj1_MUMPS.json n=263,743 nnz=1.3M —
    SuiteSparse matrices are not redistributable, so we generate).
    Unsymmetric values, strictly diagonally dominant rows.
    """
    from scipy.spatial import cKDTree  # baked into the image

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    # E[deg] = pi r^2 n  ->  r = sqrt(avg_degree / (pi n))
    r = float(np.sqrt(avg_degree / (np.pi * n)))
    pairs = cKDTree(pts).query_pairs(r, output_type="ndarray")
    ii = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
    jj = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
    vals = rng.normal(size=len(ii))
    diag = ii == jj
    vals[diag] = 0.0
    rowsum = np.zeros(n)
    np.add.at(rowsum, ii, np.abs(vals))
    vals[diag] = rowsum[np.arange(n)] + dom
    return CooMatrix.from_arrays(n, n, ii.astype(np.int64),
                                 jj.astype(np.int64), vals)


def laplacian_3d(npoint: int, conv: float = 0.0) -> CooMatrix:
    """7-point negative Laplacian on an npoint³ unit-cube grid, optionally
    with a first-order convection term (``conv`` > 0 makes the operator
    UNSYMMETRIC via one-sided differences) — the FEM/FDM-class large
    benchmark generator (stands in for the reference's SuiteSparse
    headliners, data/logs/ASIC_680k_MUMPS.json et al., which are not
    redistributable). Assembled vectorized for npoint³ ~ 10⁶."""
    n = npoint ** 3
    h = 1.0 / (npoint - 1) if npoint > 1 else 1.0
    c = 1.0 / (h * h)
    cv = conv / h
    idx = np.arange(n, dtype=np.int64)
    k = idx % npoint
    j = (idx // npoint) % npoint
    i = idx // (npoint * npoint)
    ii = [idx]
    jj = [idx]
    vv = [np.full(n, 6.0 * c + 3.0 * cv)]
    for coord, stride in ((k, 1), (j, npoint), (i, npoint * npoint)):
        lo = coord > 0
        ii.append(idx[lo]); jj.append(idx[lo] - stride)
        vv.append(np.full(int(lo.sum()), -c - cv))
        hi = coord < npoint - 1
        ii.append(idx[hi]); jj.append(idx[hi] + stride)
        vv.append(np.full(int(hi.sum()), -c))
    return CooMatrix.from_arrays(
        n, n, np.concatenate(ii), np.concatenate(jj), np.concatenate(vv))
