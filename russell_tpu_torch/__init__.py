"""russell_tpu_torch — the PyTorch and CUDA port of ``russell_tpu``.

A second package beside ``russell_tpu``, written for one NVIDIA H100.
``russell_tpu`` (JAX) stays as it is and is the reference this package
is held against. Module names mirror ``russell_tpu``'s, so each module's
counterpart is found under the same path.

The port goes slice by slice (ROADMAP.md). So far: the ``russell_lab``
layer (core, math, dense, algo), the ODE solver surface, the sparse
formats, solvers and BSR products, and the PDE and continuation tools on
them:

- ``ode``    : OdeSolver with every method (Radau5, forward and backward
               Euler, the 13 explicit Runge-Kutta tableaux), Output with
               dense output, analytic, autodiff and numerical Jacobians,
               parameters, statistics, stiffness detection, the
               reference's samples; the whole integration on the device
               (``fused=True``, ``solve_batch``) as a captured CUDA graph
- ``sparse`` : COO/CSR/CSC matrices, samples, MatrixMarket I/O,
               VerifyLinSys, orderings, SPLU (host plan + numeric scan
               with its CUDA kernels), GRIDMF, GENMF, BANDED, every path of
               ``factor``, ``LinSolver``, the numerical Jacobian, BSR
               SpMV/SpMM and block SpGEMM (three CUDA kernels)
- ``pde``    : grids, boundary conditions, Fdm1d/Fdm2d, Spc1d/Spc2d,
               SpcMap2d, transfinite maps and metrics; every solve through
               ``LinSolver``
- ``nonlin`` : natural and pseudo-arclength continuation, its Gu
               factorizations and solves through ``factor``
- ``core``   : check assertions, norms, stopwatch, formatters, grid
               generators, sorting, peaks, table readers (re-exported
               here as ``russell_tpu`` re-exports them)
- ``math``   : special functions (Bessel, gamma/beta, erf, elliptic
               integrals, Chebyshev and Legendre polynomials and point
               sets, composition and float helpers, constants)
- ``dense``  : the ``russell_lab`` vector/matvec/matrix surface over
               ``torch.linalg``, and the cyclic Jacobi eigensolver as a
               CUDA kernel
- ``algo``   : interpolation, root finding, minimization, quadrature, the
               dense Newton solver, B-splines and the test functions
- ``bin``    : the ``solve_matrix_market`` CLI
- ``native`` : the host C++ symbolic engine (orderings, block fill)
- ``csrc``   : the CUDA kernels, built with nvcc at first use
- ``interop``: plans, factors, BSR matrices, SpGEMM plans and
               continuation configurations and outputs to and from
               ``russell_tpu``'s

Tensors are f64/complex128 and live on an explicit ``device``: the card
("cuda") unless the caller asks for the CPU. In ``core``, ``math``,
``dense`` and ``algo`` a function given a tensor computes on its device,
and one given a float, list or numpy array on its ``device=`` keyword
(the card by default); the functions the reference runs on the host stay
there. This package never imports jax.
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

__all__ = [
    "device", "core", "approx_eq", "array_approx_eq", "assert_alike",
    "complex_approx_eq", "complex_array_approx_eq", "deriv1_approx_eq",
    "deriv2_approx_eq", "Norm", "Stopwatch", "format_fortran",
    "format_scientific", "format_nanoseconds", "linspace", "generate2d",
    "generate3d"]

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


# the names russell_tpu re-exports from its core (imported last: core's
# modules call ``device`` above)
from russell_tpu_torch import core  # noqa: E402
from russell_tpu_torch.core import (  # noqa: E402
    approx_eq,
    array_approx_eq,
    assert_alike,
    complex_approx_eq,
    complex_array_approx_eq,
    deriv1_approx_eq,
    deriv2_approx_eq,
    Norm,
    Stopwatch,
    format_fortran,
    format_scientific,
    format_nanoseconds,
    linspace,
    generate2d,
    generate3d,
)
