"""russell_tpu_torch — the PyTorch and CUDA port of ``russell_tpu``.

A second package beside ``russell_tpu``, written for one NVIDIA H100.
``russell_tpu`` (JAX) stays as it is and is the reference this package
is held against. Module names mirror ``russell_tpu``'s, so each module's
counterpart is found under the same path.

The port goes slice by slice (ROADMAP.md). This slice is the Radau5
stepper on the SPLU sparse solver:

- ``ode``    : Radau5 host stepper, parameters, statistics, samples
               (the 2-D Brusselator PDE and van der Pol)
- ``sparse`` : COO matrix, orderings, SPLU (host plan + numeric scan
               with its two CUDA kernels), the SPLU path of ``factor``
- ``native`` : the host C++ symbolic engine (orderings, block fill)
- ``csrc``   : the CUDA kernels, built with nvcc at first use
- ``interop``: SPLU plans and factors to and from ``russell_tpu``'s

Tensors are f64/complex128 and live on an explicit ``device``; this
package never imports jax.
"""

from __future__ import annotations

import torch

__all__ = ["device"]

__version__ = "0.1.0"


def device(name="cpu") -> torch.device:
    """The torch device ``name`` names, exactly: no fallback. Asking for
    a CUDA device when ``torch.cuda.is_available()`` is false raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for, but torch "
                           "sees no CUDA device")
    return dev
