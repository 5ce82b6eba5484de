"""Dense linear algebra: the ``russell_lab`` vector/matvec/matrix surface,
in PyTorch (counterpart of ``russell_tpu.dense``; reference:
russell_lab/src/{vector,matvec,matrix}).

Torch and ``torch.linalg`` ops on the device rule of ``core/_place.py``
(a tensor's own device, else ``device=``, the card by default),
dtype-polymorphic (complex tensors cover the ``complex_*`` twins); the
cyclic Jacobi eigensolver runs the CUDA kernel ``csrc/jacobi_eig.cu`` on
the card.
"""

from russell_tpu_torch.dense.vector_ops import (
    vec_add, vec_copy, vec_inner, vec_norm, vec_scale, vec_update,
    vec_rms_scaled, vec_max_abs_diff, vec_max_scaled, vec_all_finite,
    vec_fmt_scientific, complex_vec_zip, complex_vec_unzip,
)
from russell_tpu_torch.dense.matvec_ops import (
    mat_vec_mul, vec_mat_mul, vec_outer, vec_outer_update, mat_vec_mul_update,
    mat_sum_rows, mat_sum_cols, solve_lin_sys,
)
from russell_tpu_torch.dense.matrix_ops import (
    mat_add, mat_copy, mat_scale, mat_update, mat_mat_mul, mat_t_mat_mul,
    mat_cholesky, mat_eigen, mat_eigenvalues, mat_eigen_sym,
    mat_eigen_sym_jacobi, mat_gen_eigen, mat_svd, mat_inverse,
    mat_pseudo_inverse, mat_norm, mat_max_abs_diff, mat_sym_rank_op,
    mat_convert_to_blas_band, mat_to_numpy, mat_to_mathematica,
    complex_mat_zip, complex_mat_unzip, mat_eigen_herm,
)
