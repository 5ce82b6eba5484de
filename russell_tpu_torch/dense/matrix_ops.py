"""Matrix (BLAS L3 / LAPACK-class) operations.

Counterpart of ``russell_tpu.dense.matrix_ops`` (reference:
russell_lab/src/matrix/: dgemm, dpotrf, dsyev, dgeev, dgesvd, dgetrf+i).
Dtype-polymorphic torch and ``torch.linalg`` ops on the device rule of
``core/_place.py``: the first tensor argument's device, else ``device=``
(the card by default). ``mat_to_numpy`` and ``mat_to_mathematica`` are
host text exporters and ``mat_convert_to_blas_band`` fills its band on
the host, as in the reference.

``mat_eigen_sym_jacobi`` is the one function here with a hand-written
kernel: on a CUDA tensor it launches ``csrc/jacobi_eig.cu`` (the whole
decomposition in one launch: one CTA, or a thread-block cluster), on
a CPU tensor it runs its plain version, ``_jacobi_eig_plain``. Both run
the Jacobi rotations in a parallel round-robin order (``_jacobi_rounds``):
n - 1 rounds a sweep (n even) of n / 2 disjoint rotations each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from russell_tpu_torch.core._place import host, on, place
from russell_tpu_torch.core.enums import Norm, mat_norm  # noqa: F401 (re-export)
from russell_tpu_torch.sparse import _cuda

__all__ = [
    "mat_add", "mat_copy", "mat_scale", "mat_update", "mat_mat_mul",
    "mat_t_mat_mul", "mat_cholesky", "mat_eigen", "mat_eigenvalues",
    "mat_eigen_sym", "mat_eigen_sym_jacobi", "mat_gen_eigen", "mat_svd",
    "mat_inverse", "mat_pseudo_inverse", "mat_norm", "mat_max_abs_diff",
    "mat_sym_rank_op", "mat_convert_to_blas_band", "mat_to_numpy",
    "mat_to_mathematica", "complex_mat_zip", "complex_mat_unzip",
    "mat_eigen_herm", "JACOBI_SMEM_BYTES", "JACOBI_SWEEPS",
]

# jacobi_eig's routes, picked by ``_jacobi_route`` from n, this budget of
# a CTA's shared memory (the H100's 227 KB) and what the card schedules:
# (a) one CTA with A and V^T in its shared memory (n <= 118); (b) a cluster
# with them spread over its CTAs' shared memory (n <= 450 on 16 CTAs, 325
# on 8); (c) the same cluster with them in global scratch, any n >= 2.
# Tests lower the budget to run the routes at small n.
JACOBI_SMEM_BYTES = 227 * 1024
# the largest cluster tried: 16, a non-portable size that the H100
# schedules and that took 21 % less time than the portable 8 at n 256 on
# one (jacobi_variants.py); a card that schedules no such cluster gets 8,
# or fewer
JACOBI_CLUSTER = 16
# the reference's sweep count (matrix_ops.py:148, max_sweeps)
JACOBI_SWEEPS = 30


# -- elementwise / BLAS3 ------------------------------------------------------


def mat_add(alpha, a, beta, b, device=None):
    """C = alpha*A + beta*B (matrix/mat_add.rs)."""
    a, b = on(a, b, device=device)
    return alpha * a + beta * b


def mat_copy(a, device=None):
    (a,) = on(a, device=device)
    return a.clone()


def mat_scale(alpha, a, device=None):
    (a,) = on(a, device=device)
    return alpha * a


def mat_update(alpha, a, b, device=None):
    """B += alpha*A (matrix/mat_update.rs), as a new tensor."""
    a, b = on(a, b, device=device)
    return b + alpha * a


def mat_mat_mul(alpha, a, b, device=None):
    """C = alpha * A @ B (matrix/mat_mat_mul.rs, dgemm)."""
    a, b = on(a, b, device=device)
    return alpha * torch.matmul(a, b)


def mat_t_mat_mul(alpha, a, b, device=None):
    """C = alpha * A^T @ B (matrix/mat_t_mat_mul.rs)."""
    a, b = on(a, b, device=device)
    return alpha * torch.matmul(a.mT, b)


def mat_sym_rank_op(alpha, a, beta, c, transposed=False, device=None):
    """C = alpha*A@A^T + beta*C (or A^T@A) — dsyrk (matrix/mat_sym_rank_op.rs)."""
    a, c = on(a, c, device=device)
    aat = a.mT @ a if transposed else a @ a.mT
    return alpha * aat + beta * c


def mat_max_abs_diff(a, b, device=None):
    a, b = on(a, b, device=device)
    return torch.max(torch.abs(a - b))


# -- factorizations / decompositions -----------------------------------------


def mat_cholesky(a, lower: bool = True, device=None):
    """Cholesky factor (matrix/mat_cholesky.rs, dpotrf/zpotrf)."""
    (a,) = on(a, device=device)
    c = torch.linalg.cholesky(a)
    return c if lower else c.mT.conj()


def mat_eigen(a, device=None):
    """General eigendecomposition (matrix/mat_eigen.rs, dgeev), batched
    over leading dimensions.

    Returns (l_real, l_imag, v_real, v_imag) — the unpacked form the
    reference produces from LAPACK's compact conjugate-pair representation
    (internal/dgeev_data.rs) — as real tensors on ``a``'s device.
    ``torch.linalg.eig`` runs on that device (on a CUDA tensor torch
    synchronises with the host and uses MAGMA or cuSOLVER); the reference
    runs LAPACK geev in an explicit host callback. Eigenvector phases
    differ between the libraries: compare them by invariants."""
    (a,) = on(a, device=device)
    w, v = torch.linalg.eig(a)
    return w.real, w.imag, v.real, v.imag


def mat_eigenvalues(a, device=None):
    """Eigenvalues only (matrix/mat_eigenvalues.rs): a complex tensor on
    ``a``'s device."""
    lr, li, _, _ = mat_eigen(a, device=device)
    return torch.complex(lr, li)


def mat_eigen_sym(a, device=None):
    """Symmetric/hermitian eigendecomposition (matrix/mat_eigen_sym.rs,
    dsyev): (eigenvalues ascending, eigenvectors as columns), through
    ``torch.linalg.eigh``."""
    (a,) = on(a, device=device)
    return torch.linalg.eigh(a)


def mat_eigen_herm(a, device=None):
    """Hermitian eigendecomposition (complex_mat_eigen_herm.rs, zheev)."""
    return mat_eigen_sym(a, device=device)


def _jacobi_rounds(n):
    """The rotation order of ``jacobi_eig`` and its plain version, one sweep:
    a parallel round-robin ("circle") order. m = n rounded up to even;
    round r = 0 .. m - 2 pairs slot 0 as (r, m - 1) and slot k = 1 ..
    m / 2 - 1 as ((r + k) mod (m - 1), (r - k) mod (m - 1)), each pair
    taken as p = min, q = max, and for odd n the pair holding the phantom
    index n is left out. Every pair (p, q) comes once a sweep, and a
    round's pairs are disjoint. Returns a list of (p, q) int64 arrays, one
    per round, in slot order."""
    m = n + n % 2
    k = np.arange(1, m // 2)
    rounds = []
    for r in range(m - 1):
        a = np.concatenate(([r], (r + k) % (m - 1)))
        b = np.concatenate(([m - 1], (r - k) % (m - 1)))
        p, q = np.minimum(a, b), np.maximum(a, b)
        keep = q < n
        rounds.append((p[keep], q[keep]))
    return rounds


def _rotations(apq, app, aqq):
    """c and s of the Jacobi rotations that zero the a_pq of a round's
    pairs (float64 numpy arrays): the reference's Rutishauser t
    (matrix_ops.py:166-176; theta = 0, an equal diagonal, gives t = 1,
    a_pq = 0 gives t = 0), each operation rounded once by numpy, whose
    ``sqrt`` rounds correctly as the kernel's ``__dsqrt_rn`` does (this
    CPU build's ``torch.sqrt`` misses by an ulp at 2.0)."""
    with np.errstate(over="ignore", invalid="ignore"):
        vanishes = apq == 0.0
        theta = (aqq - app) / (2.0 * np.where(vanishes, 1.0, apq))
        sgn = np.where(theta >= 0.0, 1.0, -1.0)
        t = sgn / (np.abs(theta) + np.sqrt(1.0 + theta * theta))
        t = np.where(vanishes, 0.0, t)
        c = 1.0 / np.sqrt(1.0 + t * t)
        return c, t * c


def _jacobi_eig_plain(a, max_sweeps):
    """Plain PyTorch version of ``jacobi_eig``: ``max_sweeps`` sweeps of
    the rounds of ``_jacobi_rounds``. A round takes every pair's c and s
    from the round's starting A (``_rotations``, one host read of the
    pairs' a_pq, a_pp, a_qq), then rows P, Q of A (gathered, rotated,
    scattered back: row p <- row p c - row q s, row q <- row p s + row q
    c), then its columns P, Q the same way, then columns P, Q of V, as
    torch ops vectorised over the round's pairs, each product, sum and
    difference rounded on its own. Returns (diag(A), V) unsorted."""
    n = a.shape[0]
    A = a.clone()
    V = torch.eye(n, dtype=a.dtype, device=a.device)
    rounds = [(torch.as_tensor(p, device=a.device),
               torch.as_tensor(q, device=a.device))
              for p, q in _jacobi_rounds(n)]
    for _ in range(max_sweeps):
        for P, Q in rounds:
            apq, app, aqq = torch.stack((A[P, Q], A[P, P], A[Q, Q])).cpu() \
                .numpy()
            c, s = (torch.as_tensor(x, device=a.device)
                    for x in _rotations(apq, app, aqq))
            rp, rq = A[P], A[Q]
            A[P] = rp * c[:, None] - rq * s[:, None]
            A[Q] = rp * s[:, None] + rq * c[:, None]
            cp, cq = A[:, P], A[:, Q]
            A[:, P] = cp * c - cq * s
            A[:, Q] = cp * s + cq * c
            vp, vq = V[:, P], V[:, Q]
            V[:, P] = vp * c - vq * s
            V[:, Q] = vp * s + vq * c
    return torch.diagonal(A).clone(), V


def _jacobi_plan(n, cluster, shared, ask_card=False):
    """(dynamic shared memory a CTA in bytes, doubles of global scratch, and
    with ``ask_card`` how many such launches the card holds at once, 0 where
    it schedules none) of ``jacobi_eig`` at n on ``cluster`` CTAs with the
    rows of A and V^T in shared memory or in global scratch, from
    ``jacobi_eig_plan`` in ``csrc/jacobi_eig.cu``, where the storage layout
    lives."""
    smem, work, active = ctypes.c_longlong(), ctypes.c_longlong(), \
        ctypes.c_int()
    _cuda.launch_check("jacobi_eig", _cuda.library(
        "jacobi_eig").jacobi_eig_plan(
            n, cluster, int(shared), ctypes.addressof(smem),
            ctypes.addressof(work),
            ctypes.addressof(active) if ask_card else None))
    return smem.value, work.value, active.value


def _jacobi_route(n):
    """(route name, cluster size, rows in shared memory, doubles of global
    scratch) of ``jacobi_eig`` at n: "cta" (a) while one CTA's bytes fit
    JACOBI_SMEM_BYTES, else "cluster" (b) or, where a CTA's share does not
    fit, "global" (c), on the largest cluster of at most JACOBI_CLUSTER
    CTAs (a power of two, at most n's slots) that the card schedules.
    Raises where it schedules none of 2 CTAs or more."""
    if _jacobi_plan(n, 1, True)[0] <= JACOBI_SMEM_BYTES:
        return "cta", 1, True, 0
    h = (n + n % 2) // 2
    cluster = JACOBI_CLUSTER
    while cluster > h:
        cluster //= 2
    while cluster >= 2:
        smem, work, _ = _jacobi_plan(n, cluster, True)
        shared = smem <= JACOBI_SMEM_BYTES
        _, work, active = _jacobi_plan(n, cluster, shared, ask_card=True)
        if active:
            return ("cluster" if shared else "global"), cluster, shared, work
        cluster //= 2
    raise RuntimeError(f"jacobi_eig: the card schedules no cluster of 2 to "
                       f"{JACOBI_CLUSTER} CTAs at n {n}")


def jacobi_eig(a, max_sweeps=JACOBI_SWEEPS):
    """The Jacobi rotations of ``mat_eigen_sym_jacobi``: (diag(A), V) after
    ``max_sweeps`` sweeps of ``_jacobi_rounds``, unsorted, of a square
    float64 ``a`` (n >= 2).

    A CPU tensor takes the plain version (``_jacobi_eig_plain``); a CUDA
    tensor launches ``csrc/jacobi_eig.cu`` once, on the route that
    ``_jacobi_route`` picks from n (one CTA, a cluster with A and V in
    shared memory, or the cluster on global scratch), whose output equals
    the plain version's bit for bit, or raises."""
    if a.device.type == "cpu":
        return _jacobi_eig_plain(a, max_sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_eig: no kernel for {a.device}")
    if a.dtype != torch.float64:
        raise TypeError(f"jacobi_eig: the kernel takes float64, got {a.dtype}")
    n = a.shape[-1]
    if a.dim() != 2 or a.shape[0] != n or n < 2:
        raise ValueError(f"jacobi_eig: the kernel takes (n, n) with n >= 2, "
                         f"got {tuple(a.shape)}")
    a = a.contiguous()
    _, cluster, shared, work_doubles = _jacobi_route(n)
    w = torch.empty(n, dtype=a.dtype, device=a.device)
    V = torch.empty((n, n), dtype=a.dtype, device=a.device)
    work = (torch.empty(work_doubles, dtype=a.dtype, device=a.device)
            if work_doubles else None)
    fn = _cuda.library("jacobi_eig").jacobi_eig_f64
    _cuda.launch_check("jacobi_eig", fn(
        a.data_ptr(), n, int(max_sweeps), cluster, int(shared),
        None if work is None else work.data_ptr(), work_doubles,
        w.data_ptr(), V.data_ptr(), _cuda.stream_of(a)))
    jacobi_eig.launches += 1
    return w, V


jacobi_eig.launches = 0


def reset_launch_counts():
    jacobi_eig.launches = 0


def mat_eigen_sym_jacobi(a, max_sweeps: int = JACOBI_SWEEPS, device=None):
    """Symmetric eigendecomposition via Jacobi rotations
    (matrix/mat_eigen_sym_jacobi.rs; the reference's LAPACK-free
    decomposition, kept for cross-checking). Returns (w, V) with
    A = V diag(w) V^T, w ascending: all ``max_sweeps`` sweeps run (no
    early exit), through ``jacobi_eig`` (the CUDA kernel on the card; a
    parallel rotation order where the reference runs the cyclic one),
    then a stable ``argsort``. The bits differ from the reference's. Once
    both orders have converged the values agree to 1e-12; a run cut off
    before that (``max_sweeps`` below the sweeps convergence needs, about
    5 to 7 at n 12 to 32) gives other values than the reference's
    truncated run, since the two orders reach other intermediate
    matrices."""
    (a,) = on(a, device=device)
    a = a.to(torch.float64)
    n = a.shape[0]
    if n == 1:
        return a[0], torch.ones((1, 1), dtype=a.dtype, device=a.device)
    w, V = jacobi_eig(a, max_sweeps)
    order = torch.argsort(w, stable=True)
    return w[order], V[:, order]


def mat_gen_eigen(a, b, device=None):
    """Generalized eigenproblem A v = lambda B v (matrix/mat_gen_eigen.rs,
    dggev): B^{-1} A by ``torch.linalg.solve`` on the device, then
    ``mat_eigen``; requires B nonsingular, as the reference does."""
    a, b = on(a, b, device=device)
    return mat_eigen(torch.linalg.solve(b, a))


def mat_svd(a, device=None):
    """SVD (matrix/mat_svd.rs, dgesvd): returns (s, u, vt)."""
    (a,) = on(a, device=device)
    u, s, vt = torch.linalg.svd(a, full_matrices=True)
    return s, u, vt


def mat_inverse(a, device=None):
    """Inverse + determinant (matrix/mat_inverse.rs, dgetrf/i; closed form
    for n<=3 like the reference). Returns (inv, det)."""
    (a,) = on(a, device=device)
    n = a.shape[0]
    if n == 1:
        det = a[0, 0]
        return torch.ones((1, 1), dtype=a.dtype, device=a.device) / det, det
    if n == 2:
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        inv = torch.stack([torch.stack([a[1, 1], -a[0, 1]]),
                           torch.stack([-a[1, 0], a[0, 0]])]) / det
        return inv, det
    if n == 3:
        det = (
            a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
        )
        adj = torch.stack([
            torch.stack([a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1],
                         a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2],
                         a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]]),
            torch.stack([a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2],
                         a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
                         a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]]),
            torch.stack([a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0],
                         a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1],
                         a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]]),
        ])
        return adj / det, det
    return torch.linalg.inv(a), torch.linalg.det(a)


def mat_pseudo_inverse(a, rcond: float = 1e-15, device=None):
    """Moore-Penrose pseudo-inverse via SVD (matrix/mat_pseudo_inverse.rs):
    singular values at or below ``rcond`` times the largest are dropped,
    as ``jnp.linalg.pinv``'s ``rtol`` drops them (``torch.linalg.pinv``'s
    ``rtol``, with no absolute tolerance)."""
    (a,) = on(a, device=device)
    return torch.linalg.pinv(a, rtol=rcond)


# -- band/exporters/zip --------------------------------------------------------


def mat_convert_to_blas_band(a, kl: int, ku: int, device=None):
    """Dense -> LAPACK banded storage (matrix/mat_convert_to_blas_band.rs):
    band[ku + i - j, j] = a[i, j] for max(0, j-ku) <= i <= min(m-1, j+kl).
    Filled by a host loop, as in the reference; the band goes to ``a``'s
    device (``device=`` for a non-tensor ``a``)."""
    dev = place(a, device=device)
    a = host(a)
    m, n = a.shape
    band = np.zeros((kl + ku + 1, n), dtype=a.dtype)
    for j in range(n):
        for i in range(max(0, j - ku), min(m, j + kl + 1)):
            band[ku + i - j, j] = a[i, j]
    return torch.as_tensor(band, device=dev)


def mat_to_numpy(a, name: str = "a") -> str:
    """Python/NumPy source text exporter (matrix/mat_to_numpy.rs): host."""
    a = host(a)
    rows = ",\n    ".join(
        "[" + ", ".join(f"{v!r}" for v in row) + "]" for row in a
    )
    return f"{name} = np.array([\n    {rows},\n])"


def mat_to_mathematica(a) -> str:
    """Mathematica source text exporter (matrix/mat_to_mathematica.rs):
    host."""
    a = host(a)

    def fmt(v):
        return f"{v:.17g}".replace("e", "*^")

    rows = ",".join("{" + ",".join(fmt(v) for v in row) + "}" for row in a)
    return "{" + rows + "}"


def complex_mat_zip(real, imag, device=None):
    """Complex matrix from (real, imag) (complex_mat_zip.rs)."""
    real, imag = on(real, imag, device=device)
    return torch.complex(real.to(torch.float64), imag.to(torch.float64))


def complex_mat_unzip(z, device=None):
    (z,) = on(z, device=device)
    return z.real, z.imag
