"""Matrix-vector (BLAS L2-class) operations.

Counterpart of ``russell_tpu.dense.matvec_ops`` (reference:
russell_lab/src/matvec/: mat_vec_mul=dgemv, vec_mat_mul, vec_outer=dger,
mat_sum_rows/cols, solve_lin_sys=dgesv, and the complex twins), in torch
ops on the device rule of ``core/_place.py``.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.core._place import on

__all__ = [
    "mat_vec_mul", "vec_mat_mul", "vec_outer", "vec_outer_update",
    "mat_vec_mul_update", "mat_sum_rows", "mat_sum_cols", "solve_lin_sys",
]


def mat_vec_mul(alpha, a, u, device=None):
    """v = alpha * A @ u (matvec/mat_vec_mul.rs, dgemv)."""
    a, u = on(a, u, device=device)
    return alpha * a @ u


def mat_vec_mul_update(alpha, a, u, beta, v, device=None):
    """v = alpha*A@u + beta*v (matvec/mat_vec_mul_update.rs)."""
    a, u, v = on(a, u, v, device=device)
    return alpha * a @ u + beta * v


def vec_mat_mul(alpha, u, a, device=None):
    """v = alpha * u^T A (matvec/vec_mat_mul.rs)."""
    u, a = on(u, a, device=device)
    return alpha * u @ a


def vec_outer(alpha, u, v, device=None):
    """A = alpha * u v^T (matvec/vec_outer.rs, dger)."""
    u, v = on(u, v, device=device)
    return alpha * torch.outer(u, v)


def vec_outer_update(alpha, u, v, a, device=None):
    """A += alpha * u v^T (matvec/vec_outer_update.rs), as a new tensor."""
    u, v, a = on(u, v, a, device=device)
    return a + alpha * torch.outer(u, v)


def mat_sum_rows(a, device=None):
    """Vector of column sums: sum over rows (matvec/mat_sum_rows.rs)."""
    (a,) = on(a, device=device)
    return torch.sum(a, dim=0)


def mat_sum_cols(a, device=None):
    """Vector of row sums: sum over columns (matvec/mat_sum_cols.rs)."""
    (a,) = on(a, device=device)
    return torch.sum(a, dim=1)


def solve_lin_sys(a, b, device=None):
    """x = A^{-1} b dense with partial pivoting (matvec/solve_lin_sys.rs,
    dgesv/zgesv): ``torch.linalg.solve`` on the operands' device; complex
    dtypes included."""
    a, b = on(a, b, device=device)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("matrix must be square")
    if b.shape[0] != a.shape[0]:
        raise ValueError("rhs vector is incompatible")
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.linalg.solve(a, b)
