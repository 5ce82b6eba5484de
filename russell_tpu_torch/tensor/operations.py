"""Tensor operations — dots, double-dots, dyads.

Counterpart of ``russell_tpu.tensor.operations`` (reference contracts:
russell_tensor/src/{operations_t2.rs, operations_t4.rs,
operations_mix1.rs, operations_mix2.rs}). In the Mandel basis each reduces
to a vector/matrix product:

- a : b        = a_vec . b_vec                 (t2_ddot_t2)
- D : a        = D_mat @ a_vec                 (t4_ddot_t2)
- a : D        = D_mat^T @ a_vec               (t2_ddot_t4)
- C : D        = C_mat @ D_mat                 (t4_ddot_t4)
- a dyad b     = outer(a_vec, b_vec)           (t2_dyad_t2)
- odyad/udyad/qsd built from the 3x3 forms.

The reference builds a tensor from a 3x3 form as n² scalars, each a sum
of up to four evaluations of the form; here an index and weight table per
Mandel basis and form (built once on the host) turns that into a few
gathers, in the reference's order of addition.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from russell_tpu_torch.core._place import on
from russell_tpu_torch.tensor.enums import Mandel
from russell_tpu_torch.tensor.tensor2 import Tensor2
from russell_tpu_torch.tensor.tensor4 import Tensor4

__all__ = ["t2_ddot_t2", "t2_dot_t2", "t2_dyad_t2", "t2_odyad_t2",
           "t2_udyad_t2", "t2_qsd_t2", "t4_ddot_t2", "t2_ddot_t4",
           "t4_ddot_t4", "vec_dyad_vec", "t2_add", "t4_add"]

SQRT2 = math.sqrt(2.0)

# Mandel index -> (i, j) for the 9D basis
M_TO_IJ = [(0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2), (1, 0), (2, 1),
           (2, 0)]

# A 3x3 form f(A, B, i, j, k, l) as a sum of products of entries of the
# operands A, B and the identity E, each entry named by its operand and
# the two letters of (i, j, k, l) that index it.
FORMS = {
    "odyad": ((("A", "ik"), ("B", "jl")),),      # A_ik B_jl
    "udyad": ((("A", "il"), ("B", "jk")),),      # A_il B_jk
    "inverse": ((("A", "ik"), ("B", "lj")),),    # A_ik B_lj
    "squared": ((("E", "ik"), ("A", "lj")),      # d_ik A_lj + A_ik d_jl
                (("A", "ik"), ("E", "jl"))),
}
_OFFSET = {"A": 0, "B": 9, "E": 18}
_ZERO = 27      # the source vector's last slot holds 0.0


def _same(a: Tensor2, b: Tensor2):
    if a.mandel != b.mandel:
        raise ValueError("tensors must have the same Mandel basis")


@functools.lru_cache(maxsize=None)
def _form_table(mandel: Mandel, form: str):
    """Host tables of the form over ``mandel``'s n x n entries: for each
    of the up to four index orders the reference sums (ijkl, ijlk, jikl,
    jilk; a missing one reads the zero slot) and each product term, the
    flat source indices of its two factors; and the weights a, w1, w2 of
    the reference's ``((a * sum) * w1) * w2``."""
    n = mandel.dim()
    terms = FORMS[form]
    left = np.full((4, len(terms), n * n), _ZERO, dtype=np.int64)
    right = np.full((4, len(terms), n * n), _ZERO, dtype=np.int64)
    a = np.ones(n * n)
    w1 = np.ones(n * n)
    w2 = np.ones(n * n)
    for mi in range(n):
        i, j = M_TO_IJ[mi]
        for mj in range(n):
            k, l = M_TO_IJ[mj]
            e = mi * n + mj
            if mi < 3 and mj < 3:
                orders = [(i, j, k, l)]
            elif mi < 3:
                orders = [(i, j, k, l), (i, j, l, k)]
                a[e], w1[e] = 0.5, SQRT2
            elif mj < 3:
                orders = [(i, j, k, l), (j, i, k, l)]
                a[e], w1[e] = 0.5, SQRT2
            else:
                orders = [(i, j, k, l), (i, j, l, k), (j, i, k, l),
                          (j, i, l, k)]
                a[e], w1[e], w2[e] = 0.25, SQRT2, SQRT2
            for p, ijkl in enumerate(orders):
                at = dict(zip("ijkl", ijkl))
                for t, ((x, xs), (y, ys)) in enumerate(terms):
                    left[p, t, e] = _OFFSET[x] + 3 * at[xs[0]] + at[xs[1]]
                    right[p, t, e] = _OFFSET[y] + 3 * at[ys[0]] + at[ys[1]]
    return left, right, a, w1, w2


@functools.lru_cache(maxsize=None)
def _form_tensors(mandel: Mandel, form: str, device: torch.device):
    """``_form_table`` on ``device``, uploaded once per device."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in _form_table(mandel, form))


def _build_from_3x3_form(alpha, A, B, form: str, mandel: Mandel) -> Tensor4:
    """D[(ij),(kl)] = alpha * form(A, B, i, j, k, l) expressed in the
    (symmetric) Mandel matrix basis — the minor-symmetrized projection,
    matching the reference's usage in constitutive models. Sums the index
    orders and product terms in the reference's order."""
    assert mandel.symmetric()
    n = mandel.dim()
    left, right, a, w1, w2 = _form_tensors(mandel, form, A.device)
    src = torch.cat([A.reshape(9), B.reshape(9),
                     torch.eye(3, dtype=A.dtype, device=A.device).reshape(9),
                     torch.zeros(1, dtype=A.dtype, device=A.device)])
    s = None
    for p in range(left.shape[0]):
        f = None
        for t in range(left.shape[1]):
            term = src[left[p, t]] * src[right[p, t]]
            f = term if f is None else f + term
        s = f if s is None else s + f
    val = ((a * s) * w1) * w2
    return Tensor4(mandel, alpha * val.reshape(n, n))


def t2_ddot_t2(a: Tensor2, b: Tensor2):
    """s = a : b (operations_t2.rs)."""
    _same(a, b)
    return torch.sum(a.vec * b.vec)


def t2_dot_t2(a: Tensor2, b: Tensor2) -> Tensor2:
    """c = a . b (single contraction); result is GENERAL unless both are
    diagonal-compatible."""
    m = a.as_matrix() @ b.as_matrix()
    return Tensor2.from_matrix(m, Mandel.GENERAL)


def t2_dyad_t2(alpha, a: Tensor2, b: Tensor2) -> Tensor4:
    """D = alpha a dyad b (operations_t2.rs)."""
    _same(a, b)
    return Tensor4(a.mandel, alpha * torch.outer(a.vec, b.vec))


def _sym_basis(mandel: Mandel) -> Mandel:
    return mandel if mandel.symmetric() else Mandel.SYMMETRIC


def t2_odyad_t2(alpha, a: Tensor2, b: Tensor2) -> Tensor4:
    """D = alpha (a obar b): D_ijkl = a_ik b_jl (operations_t2.rs).

    Result in the SYMMETRIC basis via the symmetrized projection (valid
    when contracted with symmetric tensors, as in the reference usage)."""
    return _build_from_3x3_form(alpha, a.as_matrix(), b.as_matrix(),
                                "odyad", _sym_basis(a.mandel))


def t2_udyad_t2(alpha, a: Tensor2, b: Tensor2) -> Tensor4:
    """D = alpha (a ubar b): D_ijkl = a_il b_jk."""
    return _build_from_3x3_form(alpha, a.as_matrix(), b.as_matrix(),
                                "udyad", _sym_basis(a.mandel))


def t2_qsd_t2(alpha, a: Tensor2, b: Tensor2) -> Tensor4:
    """D = alpha (a qsd b) = alpha/2 (a obar b + a ubar b + b obar a +
    b ubar a) — the quad-symmetrized dyad (operations_t2.rs)."""
    h = alpha * 0.5
    o1 = t2_odyad_t2(h, a, b)
    u1 = t2_udyad_t2(h, a, b)
    o2 = t2_odyad_t2(h, b, a)
    u2 = t2_udyad_t2(h, b, a)
    return Tensor4(o1.mandel, o1.mat + u1.mat + o2.mat + u2.mat)


def t4_ddot_t2(alpha, dd: Tensor4, a: Tensor2) -> Tensor2:
    """b = alpha D : a = alpha D_mat @ a_vec (operations_mix1.rs)."""
    if dd.mandel != a.mandel:
        raise ValueError("tensors must have the same Mandel basis")
    return Tensor2(a.mandel, alpha * (dd.mat @ a.vec))


def t2_ddot_t4(alpha, a: Tensor2, dd: Tensor4) -> Tensor2:
    """b = alpha a : D = alpha D_mat^T @ a_vec."""
    if dd.mandel != a.mandel:
        raise ValueError("tensors must have the same Mandel basis")
    return Tensor2(a.mandel, alpha * (dd.mat.T @ a.vec))


def t4_ddot_t4(alpha, cc: Tensor4, dd: Tensor4) -> Tensor4:
    """E = alpha C : D = alpha C_mat @ D_mat (operations_t4.rs)."""
    if cc.mandel != dd.mandel:
        raise ValueError("tensors must have the same Mandel basis")
    return Tensor4(cc.mandel, alpha * (cc.mat @ dd.mat))


def vec_dyad_vec(alpha, u, v, mandel: Mandel = Mandel.SYMMETRIC,
                 device=None) -> Tensor2:
    """T = alpha (u dyad v), symmetrized for symmetric bases
    (operations_mix2.rs); u and v follow the device rule."""
    u, v = on(u, v, device=device, dtype=torch.float64)
    m = alpha * torch.outer(u, v)
    if mandel.symmetric():
        m = 0.5 * (m + m.T)
    return Tensor2.from_matrix(m, mandel)


def t2_add(alpha, a: Tensor2, beta, b: Tensor2) -> Tensor2:
    _same(a, b)
    return Tensor2(a.mandel, alpha * a.vec + beta * b.vec)


def t4_add(alpha, a: Tensor4, beta, b: Tensor4) -> Tensor4:
    if a.mandel != b.mandel:
        raise ValueError("tensors must have the same Mandel basis")
    return Tensor4(a.mandel, alpha * a.mat + beta * b.mat)
