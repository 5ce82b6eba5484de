"""Arithmetic of the fused ODE loops over a leading lane dimension.

The fused Radau5 and ERK steps (``radau5_fused.py``, ``erk_fused.py``) run
on the device the control arithmetic that the host-stepped path runs in
Python floats. For their counters to be the host path's, each scalar
operation has to give the host's bits: ``lane_pow`` is the C library's
pow, ``lane_div`` divides with one rounding, ``lane_sum`` reduces one lane
as the host reduces its vector. ``Lanes`` calls the system's functions on
one lane directly and on several through ``torch.func.vmap``; ``put`` and
``tree_commit`` write only the lanes of a mask.
"""

from __future__ import annotations

import torch

__all__ = ["Lanes", "lane_pow", "lane_div", "lane_sum", "put",
           "tree_commit"]


def _lane_pow_plain(base, e):
    """Plain version of ``lane_pow``: the C library's pow per value (a
    strided operand keeps PyTorch's CPU kernel on its scalar loop, whose
    pow is the C library's; its vectorized pow, taken for 8 or more
    values, and its products for some exponents, such as x ** 3.0 as
    x * x * x, differ from it in the last bit)."""
    base = torch.stack([base, base], dim=-1)[..., 0]
    return torch.pow(base, torch.full_like(base, e))


def lane_pow(base: torch.Tensor, e: float) -> torch.Tensor:
    """``base ** e`` per value as the host path's Python floats compute
    it (the C library's pow, correctly rounded but for rare near-halfway
    results). A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/lane_pow.cu`` (double-double exp and log, one rounding), or
    raises: CUDA's own pow often differs from it in the last bit."""
    if base.device.type == "cpu":
        return _lane_pow_plain(base, e)
    if base.device.type != "cuda":
        raise ValueError(f"lane_pow: no kernel for {base.device}")
    if base.dtype != torch.float64:
        raise TypeError(f"lane_pow: the kernel takes float64, got "
                        f"{base.dtype}")
    from russell_tpu_torch.sparse import _cuda
    b = base.contiguous()
    out = torch.empty_like(b)
    fn = _cuda.library("lane_pow").pow_cr_f64
    _cuda.launch_check("lane_pow", fn(b.data_ptr(), float(e), b.numel(),
                                      out.data_ptr(), _cuda.stream_of(b)))
    lane_pow.launches += 1
    return out


lane_pow.launches = 0


def lane_div(a, b) -> torch.Tensor:
    """a / b per lane with one rounding, where one of them is a Python
    float, as the host path divides Python floats: PyTorch computes a
    float over a tensor as the float times the tensor's reciprocal, and on
    the card a tensor over a float as the tensor times its reciprocal,
    both rounding twice."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of each lane's row of v (B, n): for one lane the very
    reduction the host path runs on its (n,) vector (a (1, n) tensor may
    be reduced in another order on the card)."""
    if v.shape[0] == 1:
        return torch.sum(v[0]).reshape(1)
    return torch.sum(v, dim=1)


def _bc(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The lane mask (B,) broadcast against ``like`` (B, ...)."""
    return mask.view(mask.shape + (1,) * (like.dim() - 1))


def put(t: torch.Tensor, mask: torch.Tensor, value) -> None:
    """t[lane] = value[lane] where mask[lane], in place."""
    t.copy_(torch.where(_bc(mask, t), value, t))


def tree_commit(dst, src, mask: torch.Tensor) -> None:
    """Commit the lanes ``mask`` (B,) of the tensors of ``src`` (dicts,
    lists, tuples of tensors) into ``dst``'s. A tensor's leading dimension
    is its lanes, or B runs of rows, lane-major (the fronts of a batched
    multifrontal factorization); entries that are no tensor (None planes,
    host ints) are left as they are."""
    if isinstance(dst, torch.Tensor):
        B = mask.shape[0]
        if dst.shape[0] != B:
            dst, src = dst.unflatten(0, (B, -1)), src.unflatten(0, (B, -1))
        put(dst, mask, src)
    elif isinstance(dst, dict):
        for k in dst:
            tree_commit(dst[k], src[k], mask)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            tree_commit(d, s, mask)


class Lanes:
    """The system's rhs and Jacobian over a lane dimension: the plain
    functions for one lane (so a single solve computes exactly what the
    host path does), ``torch.func.vmap`` of them for several."""

    def __init__(self, system, jac_fn, lanes: int):
        self.f = system.function
        self.jac_fn = jac_fn
        self.B = lanes
        if lanes > 1:
            self._fv = system.lane_function()
            self._jv = system.lane_jacobian(jac_fn)

    def function(self, x, y):
        if self.B == 1:
            return self.f(x[0], y[0], None)[None]
        return self._fv(x, y)

    def jacobian(self, x, y):
        if self.B == 1:
            return self.jac_fn(x[0], y[0], None)[None]
        return self._jv(x, y)
