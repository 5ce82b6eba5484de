"""russell_tpu_torch — the PyTorch and CUDA port of ``russell_tpu``.

A second package beside ``russell_tpu``, written for one NVIDIA H100.
``russell_tpu`` (JAX) stays as it is and is the reference this package
is held against. Module names mirror ``russell_tpu``'s, so each module's
counterpart is found under the same path.

The port goes slice by slice (ROADMAP.md). So far: the Radau5 stepper on
the SPLU sparse solver, and the sparse formats with the BSR products:

- ``ode``    : Radau5 host stepper, parameters, statistics, samples
               (the 2-D Brusselator PDE and van der Pol)
- ``sparse`` : COO/CSR/CSC matrices, samples, MatrixMarket I/O,
               VerifyLinSys, orderings, SPLU (host plan + numeric scan
               with its two CUDA kernels), the SPLU path of ``factor``,
               BSR SpMV/SpMM and block SpGEMM (three CUDA kernels)
- ``native`` : the host C++ symbolic engine (orderings, block fill)
- ``csrc``   : the CUDA kernels, built with nvcc at first use
- ``interop``: SPLU plans and factors, BSR matrices and SpGEMM plans to
               and from ``russell_tpu``'s

Tensors are f64/complex128 and live on an explicit ``device``: the card
("cuda") unless the caller asks for the CPU. This package never imports
jax.
"""

from __future__ import annotations

import torch

__all__ = ["device"]

__version__ = "0.1.0"


def device(name="cuda") -> torch.device:
    """The torch device ``name`` names (the card by default), exactly: no
    fallback. Asking for a CUDA device when ``torch.cuda.is_available()``
    is false raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for, but torch "
                           "sees no CUDA device")
    return dev
