"""Spectral decomposition of symmetric second-order tensors.

Counterpart of ``russell_tpu.tensor.spectral2`` (reference contract:
russell_tensor/src/spectral2.rs:6,39,83): decompose a symmetric Tensor2
into eigenvalues + eigenprojectors, and compose a new tensor from
modified eigenvalues. The eigenpairs come from ``torch.linalg.eigh``
(LAPACK on the host, cuSOLVER on the card), whose eigenvectors may have
other signs than the reference's: the projectors n n^T do not. The 3-D
decomposition reads the device in ``Tensor2.from_matrix``'s checks, so it
does not batch under ``torch.func.vmap`` (nor does the reference's under
``jax.vmap``); the 2-D one does. On the card, ``torch.linalg.eigh`` sends a
batch of 3x3 matrices to cuSOLVER's batched syev, which refuses batches
from about 2^15 up (28,672 ran, 32,766 was refused on an H100 with torch
2.11 and CUDA 12.8): vmap a larger batch with ``chunk_size`` (2^14 runs).
"""

from __future__ import annotations

import math

import torch

from russell_tpu_torch.core._place import f64, place
from russell_tpu_torch.tensor.enums import Mandel
from russell_tpu_torch.tensor.tensor2 import Tensor2

__all__ = ["Spectral2"]

SQRT2 = math.sqrt(2.0)


class Spectral2:
    def __init__(self, two_dim: bool = False, device=None):
        self.mandel = Mandel.SYMMETRIC_2D if two_dim else Mandel.SYMMETRIC
        dev = place(device=device)
        self.lambdas = torch.zeros(3, dtype=torch.float64, device=dev)
        self.projectors = [Tensor2(self.mandel, device=dev)
                           for _ in range(3)]

    def decompose(self, tt: Tensor2):
        """Eigenvalues + eigenprojectors P_i = n_i dyad n_i
        (spectral2.rs:39)."""
        if not tt.mandel.symmetric():
            raise ValueError("tensor must be symmetric")
        if tt.mandel != self.mandel:
            raise ValueError("tensor has the wrong Mandel basis")
        w, v = torch.linalg.eigh(tt.as_matrix())
        self.lambdas = w
        self.projectors = []
        for i in range(3):
            n = v[:, i]
            proj = torch.outer(n, n)
            if self.mandel.two_dim():
                self.projectors.append(Tensor2(self.mandel, torch.stack(
                    [proj[0, 0], proj[1, 1], proj[2, 2],
                     SQRT2 * proj[0, 1]])))
            else:
                self.projectors.append(Tensor2.from_matrix(proj,
                                                           self.mandel))
        return self

    def compose(self, lambdas) -> Tensor2:
        """T = sum_i lambda_i P_i (spectral2.rs:83)."""
        p0 = self.projectors[0].vec
        lambdas = f64(lambdas, p0.device)
        v = torch.zeros_like(p0)
        for i in range(3):
            v = v + lambdas[i] * self.projectors[i].vec
        return Tensor2(self.mandel, v)
