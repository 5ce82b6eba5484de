"""Vector (BLAS L1-class) operations.

Counterpart of ``russell_tpu.dense.vector_ops`` (reference:
russell_lab/src/vector/). Dtype-polymorphic torch ops (the ``complex_*``
twins are covered by complex tensors) on the device rule of
``core/_place.py``: the first tensor argument's device, else ``device=``
(the card by default). ``vec_fmt_scientific`` is host text.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.core._place import on
from russell_tpu_torch.core.enums import Norm, vec_norm  # re-exported

__all__ = [
    "vec_add", "vec_copy", "vec_inner", "vec_norm", "vec_scale", "vec_update",
    "vec_rms_scaled", "vec_max_abs_diff", "vec_max_scaled", "vec_all_finite",
    "vec_fmt_scientific", "complex_vec_zip", "complex_vec_unzip",
]


def vec_add(alpha, u, beta, v, device=None):
    """w = alpha*u + beta*v (vector/vec_add.rs)."""
    u, v = on(u, v, device=device)
    return alpha * u + beta * v


def vec_copy(u, device=None):
    (u,) = on(u, device=device)
    return u.clone()


def vec_inner(u, v, device=None):
    """Dot product u . v (vector/vec_inner.rs); for complex vectors the
    real part of conj(u) . v, as in the reference."""
    u, v = on(u, v, device=device)
    if u.is_complex():
        return torch.vdot(u, v.to(u.dtype)).real
    return torch.dot(u, v)


def vec_scale(alpha, u, device=None):
    (u,) = on(u, device=device)
    return alpha * u


def vec_update(alpha, u, v, device=None):
    """v += alpha * u (vector/vec_update.rs), as a new tensor."""
    u, v = on(u, v, device=device)
    return v + alpha * u


def vec_rms_scaled(u, reference, atol, rtol, device=None):
    """Scaled root-mean-square norm sqrt(mean((u_i/(atol+rtol|ref_i|))^2))
    (vector/vec_rms_scaled.rs) — the ODE error-control norm."""
    u, ref = on(u, reference, device=device)
    scale = atol + rtol * torch.abs(ref)
    return torch.sqrt(torch.mean(torch.abs(u / scale) ** 2))


def vec_max_abs_diff(u, v, device=None):
    """max |u_i - v_i| (vector/vec_max_abs_diff.rs)."""
    u, v = on(u, v, device=device)
    return torch.max(torch.abs(u - v))


def vec_max_scaled(u, reference, device=None):
    """max |u_i| / (1 + |ref_i|) (vector/vec_max_scaled.rs)."""
    u, ref = on(u, reference, device=device)
    return torch.max(torch.abs(u) / (1.0 + torch.abs(ref)))


def vec_all_finite(u, device=None):
    """True iff every component is finite (vector/vec_all_finite.rs) —
    the ODE anomaly check: a 0-dim bool tensor."""
    (u,) = on(u, device=device)
    return torch.all(torch.isfinite(u))


def complex_vec_zip(real, imag, device=None):
    """Complex vector from (real, imag) parts (vector/complex_vec_zip.rs)."""
    real, imag = on(real, imag, device=device)
    return torch.complex(real.to(torch.float64), imag.to(torch.float64))


def complex_vec_unzip(z, device=None):
    (z,) = on(z, device=device)
    return z.real, z.imag


from russell_tpu_torch.core.formatters import vec_fmt_scientific  # noqa: E402,F401
