"""Analytical derivatives of invariants and tensor functions.

Counterpart of ``russell_tpu.tensor.derivatives`` (reference contracts:
russell_tensor/src/{derivatives_t2.rs, derivatives_t4.rs}): first and
second derivatives of I1, I2, J2, J3, sigma_m/sigma_d, Lode; the
derivatives of the inverse and squared tensors. Results live on the
argument's device; out of place, so they batch under ``torch.func.vmap``.
"""

from __future__ import annotations

import math

import torch

from russell_tpu_torch.tensor.operations import (_build_from_3x3_form,
                                                 _sym_basis, t2_dyad_t2,
                                                 t2_qsd_t2)
from russell_tpu_torch.tensor.tensor2 import Tensor2, add_to_diagonal
from russell_tpu_torch.tensor.tensor4 import Tensor4

__all__ = [
    "deriv1_invariant_ii1", "deriv1_invariant_ii2", "deriv1_invariant_jj2",
    "deriv1_invariant_jj3", "deriv1_invariant_sigma_m",
    "deriv1_invariant_sigma_d", "deriv1_invariant_lode",
    "deriv2_invariant_jj2", "deriv2_invariant_jj3", "deriv_inverse_tensor",
    "deriv_squared_tensor"]

SQRT3 = math.sqrt(3.0)


def deriv1_invariant_ii1(sigma: Tensor2) -> Tensor2:
    """dI1/dsigma = I."""
    return Tensor2.identity(sigma.mandel, sigma.device)


def deriv1_invariant_ii2(sigma: Tensor2) -> Tensor2:
    """dI2/dsigma = I1 I - sigma^T."""
    i1 = sigma.invariant_ii1()
    ident = Tensor2.identity(sigma.mandel, sigma.device)
    st = sigma.transpose()
    return Tensor2(sigma.mandel, i1 * ident.vec - st.vec)


def deriv1_invariant_jj2(sigma: Tensor2) -> Tensor2:
    """dJ2/dsigma = deviator(sigma) (symmetric sigma)."""
    return sigma.deviator()


def deriv1_invariant_jj3(sigma: Tensor2) -> Tensor2:
    """dJ3/dsigma = s.s - (2/3) J2 I (symmetric sigma)."""
    s = sigma.deviator()
    ss = s.squared()
    jj2 = sigma.invariant_jj2()
    return Tensor2(ss.mandel, add_to_diagonal(ss.vec, -2.0 / 3.0 * jj2))


def deriv1_invariant_sigma_m(sigma: Tensor2) -> Tensor2:
    """d(sigma_m)/dsigma = I/3."""
    return Tensor2.identity(sigma.mandel, sigma.device).scale(1.0 / 3.0)


def deriv1_invariant_sigma_d(sigma: Tensor2) -> Tensor2:
    """d(sigma_d)/dsigma = sqrt(3)/(2 sqrt(J2)) s; NaN-filled when J2 ~ 0."""
    jj2 = sigma.invariant_jj2()
    s = sigma.deviator()
    coef = SQRT3 / (2.0 * torch.sqrt(torch.clamp(jj2, min=1e-300)))
    v = torch.where(jj2 > 1e-10, coef * s.vec, math.nan)
    return Tensor2(sigma.mandel, v)


def deriv1_invariant_lode(sigma: Tensor2) -> Tensor2:
    """dl/dsigma with l = (3 sqrt3/2) J3 J2^{-3/2} (derivatives_t2.rs)."""
    jj2 = sigma.invariant_jj2()
    jj3 = sigma.invariant_jj3()
    d_jj2 = deriv1_invariant_jj2(sigma)
    d_jj3 = deriv1_invariant_jj3(sigma)
    a = 1.5 * SQRT3 * torch.clamp(jj2, min=1e-300) ** -1.5
    b = 2.25 * SQRT3 * jj3 * torch.clamp(jj2, min=1e-300) ** -2.5
    v = torch.where(jj2 > 1e-10, a * d_jj3.vec - b * d_jj2.vec, math.nan)
    return Tensor2(d_jj3.mandel, v)


def deriv2_invariant_jj2(sigma: Tensor2) -> Tensor4:
    """d2J2/dsigma2 = Psym - (1/3) I dyad I = Pdev."""
    return Tensor4.p_dev(sigma.mandel, sigma.device)


def deriv2_invariant_jj3(sigma: Tensor2) -> Tensor4:
    """d2J3/dsigma2 = s qsd I - (2/3) I dyad s - (2 J2/3) Pdev
    (derivatives_t4.rs: the standard closed form)."""
    s = sigma.deviator()
    ident = Tensor2.identity(sigma.mandel, sigma.device)
    jj2 = sigma.invariant_jj2()
    qsd = t2_qsd_t2(0.5, s, ident)
    dyad_is = t2_dyad_t2(2.0 / 3.0, ident, s)
    pdev = Tensor4.p_dev(sigma.mandel, sigma.device).scale(2.0 / 3.0 * jj2)
    return Tensor4(qsd.mandel, qsd.mat - dyad_is.mat - pdev.mat)


def deriv_inverse_tensor(a: Tensor2) -> Tensor4:
    """d(A^-1)/dA : (dAi/dA)_ijkl = -Ai_ik Ai_lj (symmetrized for the
    symmetric bases; derivatives_t2.rs: deriv_inverse_tensor)."""
    am = a.inverse().as_matrix()
    return _build_from_3x3_form(-1.0, am, am, "inverse", _sym_basis(a.mandel))


def deriv_squared_tensor(a: Tensor2) -> Tensor4:
    """d(A.A)/dA : (dA2/dA)_ijkl = delta_ik A_lj + A_ik delta_jl
    (symmetrized; derivatives_t2.rs: deriv_squared_tensor)."""
    am = a.as_matrix()
    return _build_from_3x3_form(1.0, am, am, "squared", _sym_basis(a.mandel))
