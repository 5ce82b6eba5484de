"""Continuum-mechanics tensor calculus in the Mandel basis.

Counterpart of ``russell_tpu.tensor`` (reference: russell_tensor/src/):
Tensor2 (9D general / 6D symmetric / 4D symmetric-2D Mandel vectors) and
Tensor4 (Mandel matrices) as f64 tensors. The Mandel basis makes every
contraction a plain vector/matrix product — t2:t2 a dot product, t4:t2 a
matvec, t4:t4 a matmul — and the operations batch under
``torch.func.vmap`` where the reference's batch under ``jax.vmap``. A
given tensor keeps its device; the constructors from numpy or from
nothing take ``device=``, the card by default.
"""

from russell_tpu_torch.tensor.enums import Mandel
from russell_tpu_torch.tensor.tensor2 import Tensor2
from russell_tpu_torch.tensor.tensor4 import Tensor4
from russell_tpu_torch.tensor.operations import (
    t2_ddot_t2, t2_dot_t2, t2_dyad_t2, t2_odyad_t2, t2_udyad_t2,
    t2_qsd_t2, t4_ddot_t2, t2_ddot_t4, t4_ddot_t4, vec_dyad_vec,
    t2_add, t4_add)
from russell_tpu_torch.tensor.derivatives import (
    deriv1_invariant_ii1, deriv1_invariant_ii2, deriv1_invariant_jj2,
    deriv1_invariant_jj3, deriv1_invariant_sigma_m, deriv1_invariant_sigma_d,
    deriv1_invariant_lode, deriv2_invariant_jj2, deriv2_invariant_jj3,
    deriv_inverse_tensor, deriv_squared_tensor)
from russell_tpu_torch.tensor.lin_elasticity import LinElasticity
from russell_tpu_torch.tensor.spectral2 import Spectral2

__all__ = [
    "Mandel", "Tensor2", "Tensor4",
    "t2_ddot_t2", "t2_dot_t2", "t2_dyad_t2", "t2_odyad_t2", "t2_udyad_t2",
    "t2_qsd_t2", "t4_ddot_t2", "t2_ddot_t4", "t4_ddot_t4", "vec_dyad_vec",
    "t2_add", "t4_add",
    "deriv1_invariant_ii1", "deriv1_invariant_ii2", "deriv1_invariant_jj2",
    "deriv1_invariant_jj3", "deriv1_invariant_sigma_m",
    "deriv1_invariant_sigma_d", "deriv1_invariant_lode",
    "deriv2_invariant_jj2", "deriv2_invariant_jj3", "deriv_inverse_tensor",
    "deriv_squared_tensor", "LinElasticity", "Spectral2",
]
