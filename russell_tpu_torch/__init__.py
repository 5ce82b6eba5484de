"""russell_tpu_torch — the PyTorch and CUDA port of ``russell_tpu``.

A second package beside ``russell_tpu``, written for one NVIDIA H100.
``russell_tpu`` (JAX) stays as it is and is the reference this package
is held against. Module names mirror ``russell_tpu``'s, so each module's
counterpart is found under the same path.

The port goes slice by slice (ROADMAP.md). So far: the ODE solver
surface on the DENSE, SPLU and GRIDMF sparse solvers, and the sparse
formats with the BSR products:

- ``ode``    : OdeSolver with every method (Radau5, forward and backward
               Euler, the 13 explicit Runge-Kutta tableaux), Output with
               dense output, analytic, autodiff and numerical Jacobians,
               parameters, statistics, stiffness detection, the
               reference's samples; the whole integration on the device
               (``fused=True``, ``solve_batch``) as a captured CUDA graph
- ``sparse`` : COO/CSR/CSC matrices, samples, MatrixMarket I/O,
               VerifyLinSys, orderings, SPLU (host plan + numeric scan
               with its CUDA kernels), GRIDMF, the DENSE, SPLU and GRIDMF
               paths of ``factor``, the numerical Jacobian, BSR SpMV/SpMM
               and block SpGEMM (three CUDA kernels)
- ``native`` : the host C++ symbolic engine (orderings, block fill)
- ``csrc``   : the CUDA kernels, built with nvcc at first use
- ``interop``: SPLU plans and factors, DENSE factors, BSR matrices and
               SpGEMM plans to and from ``russell_tpu``'s

Tensors are f64/complex128 and live on an explicit ``device``: the card
("cuda") unless the caller asks for the CPU. This package never imports
jax.
"""

from __future__ import annotations

import os

import torch

# cuSOLVER's own cuBLAS handle takes its GEMM workspace from stream-ordered
# allocations unless a default workspace is configured when the handle is
# made; the fused ODE loops capture the DENSE route's complex LU into a CUDA
# graph conditional body, which refuses allocation nodes at instantiation
# (an H100 refused the second such capture of a 800 x 800 complex128 LU).
# Configured here, before this process makes its first handle.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
