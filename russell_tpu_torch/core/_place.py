"""Where a function of ``core``, ``math``, ``dense`` and ``algo`` computes.

The port's device rule for these modules:

- a function given a tensor computes on that tensor's device;
- a function given a float, a list or a numpy array puts it on its
  ``device=`` keyword, which defaults to the card through
  ``russell_tpu_torch.device()`` (which raises without one);
- the functions the reference itself runs on the host (numpy or ``math``)
  stay there and say so in their docstrings.
"""

from __future__ import annotations

import numpy as np
import torch

import russell_tpu_torch

__all__ = ["place", "on", "f64", "host", "div"]


def place(*xs, device=None) -> torch.device:
    """The device of the first tensor among ``xs``; without one, ``device``
    (the card when it is None)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return russell_tpu_torch.device("cuda" if device is None else device)


def _tensor(x, dev, dtype):
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    a = np.asarray(x)
    if dtype is None and a.dtype.kind in "biu":
        a = a.astype(np.float64)
    return torch.as_tensor(a, dtype=dtype, device=dev)


def on(*xs, device=None, dtype=None) -> tuple:
    """``xs`` as tensors on ``place(*xs, device=device)``: a tensor stays
    where it is (cast to ``dtype`` when given); anything else goes through
    ``np.asarray`` (Python floats are f64, complex numbers c128; integers
    and booleans become f64) onto that device."""
    dev = place(*xs, device=device)
    return tuple(_tensor(x, dev, dtype) for x in xs)


def f64(x, device=None) -> torch.Tensor:
    """``x`` as an f64 tensor on the device rule's device."""
    return on(x, device=device, dtype=torch.float64)[0]


def host(x) -> np.ndarray:
    """``x`` as numpy on the host (a tensor of any device is copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, where one of them may be a Python number:
    PyTorch computes a number over a tensor as the number times the
    tensor's reciprocal, and on the card a tensor over a number as the
    tensor times the number's reciprocal, both rounding twice. The number
    becomes a 0-dim tensor on the other's device."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)
