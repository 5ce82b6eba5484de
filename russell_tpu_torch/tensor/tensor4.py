"""Fourth-order tensor as a Mandel matrix.

Counterpart of ``russell_tpu.tensor.tensor4`` (reference contract:
russell_tensor/src/tensor4.rs:102): a (9x9 / 6x6 / 4x4) f64 matrix in the
Mandel basis; the classic constant tensors (identity II, I dyad I, the
projectors Psym/Pskew/Piso/Pdev). ``mat`` keeps a given tensor's device;
a numpy array, or nothing (zeros), goes to ``device=``, the card by
default (``core/_place.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.core._place import f64, place
from russell_tpu_torch.tensor.enums import Mandel

__all__ = ["Tensor4"]


class Tensor4:
    def __init__(self, mandel: Mandel, mat=None, device=None):
        self.mandel = mandel
        n = mandel.dim()
        if mat is None:
            self.mat = torch.zeros((n, n), dtype=torch.float64,
                                   device=place(device=device))
        else:
            mat = f64(mat, device)
            if tuple(mat.shape[-2:]) != (n, n):
                raise ValueError("matrix dims must match the Mandel basis")
            self.mat = mat

    @property
    def device(self) -> torch.device:
        return self.mat.device

    @classmethod
    def new(cls, mandel: Mandel, device=None) -> "Tensor4":
        return cls(mandel, device=device)

    # -- classic constant tensors (tensor4.rs constants) ----------------------

    @classmethod
    def identity(cls, mandel: Mandel, device=None) -> "Tensor4":
        """II : A = A (the Mandel identity matrix)."""
        return cls(mandel, np.eye(mandel.dim()), device)

    @classmethod
    def ii_dyad_ii(cls, mandel: Mandel, device=None) -> "Tensor4":
        """(I dyad I) : A = tr(A) I."""
        n = mandel.dim()
        m = np.zeros((n, n))
        m[:3, :3] = 1.0
        return cls(mandel, m, device)

    @classmethod
    def p_iso(cls, mandel: Mandel, device=None) -> "Tensor4":
        """Isotropic projector Piso = (1/3) I dyad I."""
        return cls(mandel, cls.ii_dyad_ii(mandel, device).mat / 3.0)

    @classmethod
    def p_sym(cls, mandel: Mandel, device=None) -> "Tensor4":
        """Symmetrizing projector Psym (identity on the symmetric 6D part)."""
        m = np.eye(mandel.dim())
        if mandel == Mandel.GENERAL:
            m[6:, 6:] = 0.0
        return cls(mandel, m, device)

    @classmethod
    def p_skew(cls, mandel: Mandel, device=None) -> "Tensor4":
        n = mandel.dim()
        m = np.zeros((n, n))
        if mandel == Mandel.GENERAL:
            m[6:, 6:] = np.eye(3)
        return cls(mandel, m, device)

    @classmethod
    def p_dev(cls, mandel: Mandel, device=None) -> "Tensor4":
        """Deviatoric projector Pdev = Psym - Piso."""
        return cls(mandel, cls.p_sym(mandel, device).mat
                   - cls.p_iso(mandel, device).mat)

    # -- conversions ----------------------------------------------------------

    def as_matrix_9x9(self):
        """Embed into the full 9x9 Mandel matrix (as_matrix_9x9.rs), out of
        place."""
        pad = 9 - self.mandel.dim()
        return torch.nn.functional.pad(self.mat, (0, pad, 0, pad))

    def scale(self, alpha) -> "Tensor4":
        return Tensor4(self.mandel, alpha * self.mat)

    def clone(self) -> "Tensor4":
        return Tensor4(self.mandel, self.mat)

    def __repr__(self):
        return f"Tensor4({self.mandel.name})"
