"""Sparse numerical Jacobian, in PyTorch (reference:
russell_sparse/src/numerical_jacobian.rs:129).

Counterpart of ``russell_tpu.sparse.numerical_jacobian``: alpha * J
values for a fixed (rows, cols) structure, for ODE/nonlin solvers that
lack an analytical Jacobian.

- ``numerical_jacobian``: forward differences with the step
  ``sqrt(eps) * max(|y_j|, 1)``, the ndim perturbed evaluations batched
  with ``torch.func.vmap`` (ndim + 1 rhs evaluations in all). The ODE
  ``System``'s own numerical path uses another step,
  ``sqrt(eps) * max(1e-5, |y_j|)``, as the reference package does.
- ``jacobian_values``: exact derivatives by forward-mode AD
  (``torch.func.jacfwd``).

``f(x, y, args) -> dydx`` takes and returns torch tensors and must be
functional (no in-place writes on ``y``). The values are computed on the
device of ``y``: a tensor's own, else ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

import russell_tpu_torch

__all__ = ["numerical_jacobian", "jacobian_values"]


def _state(y, device):
    if isinstance(y, torch.Tensor):
        return y if device is None else y.to(russell_tpu_torch.device(device))
    return torch.as_tensor(np.asarray(y, dtype=np.float64),
                           device=russell_tpu_torch.device(device or "cuda"))


def _index(idx, device):
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def numerical_jacobian(alpha, x, y, f, rows, cols, args=None, device=None):
    """alpha * J[rows, cols] by forward differences (the columns' rhs
    evaluations batched with vmap)."""
    y = _state(y, device)
    eps = float(np.sqrt(torch.finfo(y.dtype).eps))
    f0 = f(x, y, args)
    steps = eps * torch.clamp_min(torch.abs(y), 1.0)
    yp = y + torch.diag(steps)  # row j: y with steps[j] added at j
    jt = (torch.func.vmap(lambda yy: f(x, yy, args))(yp) - f0) \
        / steps[:, None]  # jt[j, i] = dF_i/dy_j
    return alpha * jt[_index(cols, y.device), _index(rows, y.device)]


def jacobian_values(alpha, x, y, f, rows, cols, args=None, device=None):
    """Exact alpha * J[rows, cols] via forward-mode AD (jacfwd)."""
    y = _state(y, device)
    jac = torch.func.jacfwd(lambda yy: f(x, yy, args))(y)
    return alpha * jac[_index(rows, y.device), _index(cols, y.device)]
