"""Second-order tensor in the Mandel basis.

Counterpart of ``russell_tpu.tensor.tensor2`` (reference contract:
russell_tensor/src/tensor2.rs:52). Storage:

General (9D):   [T00, T11, T22, (T01+T10)/s2, (T12+T21)/s2, (T02+T20)/s2,
                 (T01-T10)/s2, (T12-T21)/s2, (T02-T20)/s2]
Symmetric (6D): [T00, T11, T22, s2*T01, s2*T12, s2*T02]
Symmetric2D(4): [T00, T11, T22, s2*T01]

with s2 = sqrt(2). ``vec`` is an f64 tensor: a tensor given to the
constructor keeps its device, anything else (or nothing: zeros) goes to
``device=``, the card by default (``core/_place.py``). The operations are
out of place and batch under ``torch.func.vmap`` where the reference's
batch under ``jax.vmap``; ``from_matrix``'s symmetry and plane checks,
``get`` and ``norm`` read the device on the host, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from russell_tpu_torch.core._place import f64, place
from russell_tpu_torch.tensor.enums import Mandel

__all__ = ["Tensor2"]

SQRT2 = math.sqrt(2.0)
SQRT3 = math.sqrt(3.0)
SQRT6 = math.sqrt(6.0)
TOL_J2 = 1e-10


def add_to_diagonal(vec, a):
    """``vec`` with ``a`` added to its first three (diagonal) components,
    out of place (the reference's ``vec.at[:3].add(a)``)."""
    return torch.cat([vec[:3] + a, vec[3:]])


class Tensor2:
    """Mandel-vector second-order tensor (batches under torch.func.vmap)."""

    def __init__(self, mandel: Mandel, vec=None, device=None):
        self.mandel = mandel
        if vec is None:
            self.vec = torch.zeros(mandel.dim(), dtype=torch.float64,
                                   device=place(device=device))
        else:
            vec = f64(vec, device)
            if vec.shape[-1] != mandel.dim():
                raise ValueError("vector dimension must match the Mandel "
                                 "basis")
            self.vec = vec

    @property
    def device(self) -> torch.device:
        return self.vec.device

    # -- constructors ---------------------------------------------------------

    @classmethod
    def new(cls, mandel: Mandel, device=None) -> "Tensor2":
        return cls(mandel, device=device)

    @classmethod
    def new_sym(cls, two_dim: bool = False, device=None) -> "Tensor2":
        return cls(Mandel.SYMMETRIC_2D if two_dim else Mandel.SYMMETRIC,
                   device=device)

    @classmethod
    def from_matrix(cls, tt, mandel: Mandel, device=None) -> "Tensor2":
        """3x3 matrix -> Mandel vector (tensor2.rs: from_matrix)."""
        tt = f64(tt, device)
        if tt.shape != (3, 3):
            raise ValueError("matrix must be 3x3")
        if mandel.symmetric():
            sym_err = torch.max(torch.abs(tt - tt.T))
            if float(sym_err) > 1e-10:
                raise ValueError("cannot set symmetric Tensor2 with a "
                                 "non-symmetric matrix")
            if mandel.two_dim():
                if (float(torch.abs(tt[0, 2])) > 1e-10
                        or float(torch.abs(tt[1, 2])) > 1e-10):
                    raise ValueError("cannot set 2D Tensor2 with out-of-"
                                     "plane components")
                vec = torch.stack([tt[0, 0], tt[1, 1], tt[2, 2],
                                   SQRT2 * tt[0, 1]])
            else:
                vec = torch.stack([tt[0, 0], tt[1, 1], tt[2, 2],
                                   SQRT2 * tt[0, 1], SQRT2 * tt[1, 2],
                                   SQRT2 * tt[0, 2]])
        else:
            vec = torch.stack([
                tt[0, 0], tt[1, 1], tt[2, 2],
                (tt[0, 1] + tt[1, 0]) / SQRT2,
                (tt[1, 2] + tt[2, 1]) / SQRT2,
                (tt[0, 2] + tt[2, 0]) / SQRT2,
                (tt[0, 1] - tt[1, 0]) / SQRT2,
                (tt[1, 2] - tt[2, 1]) / SQRT2,
                (tt[0, 2] - tt[2, 0]) / SQRT2])
        return cls(mandel, vec)

    @classmethod
    def identity(cls, mandel: Mandel, device=None) -> "Tensor2":
        v = np.zeros(mandel.dim())
        v[:3] = 1.0
        return cls(mandel, v, device)

    @classmethod
    def from_octahedral(cls, distance, radius, lode, two_dim=False,
                        device=None):
        """Diagonal tensor from octahedral invariants (tensor2.rs:147)."""
        theta = math.acos(max(-1.0, min(1.0, lode))) / 3.0
        star1 = radius * math.cos(theta)
        star2 = distance
        star3 = radius * math.sin(theta)
        mandel = Mandel.SYMMETRIC_2D if two_dim else Mandel.SYMMETRIC
        v = np.zeros(mandel.dim())
        v[0] = (SQRT2 * star1 + star2) / SQRT3
        v[1] = -star1 / SQRT6 + star2 / SQRT3 - star3 / SQRT2
        v[2] = -star1 / SQRT6 + star2 / SQRT3 + star3 / SQRT2
        return cls(mandel, v, device)

    # -- conversions ----------------------------------------------------------

    def as_matrix(self):
        """Mandel vector -> full 3x3 matrix (tensor2.rs: as_matrix)."""
        v = self.vec
        if self.mandel == Mandel.GENERAL:
            m01 = (v[3] + v[6]) / SQRT2
            m10 = (v[3] - v[6]) / SQRT2
            m12 = (v[4] + v[7]) / SQRT2
            m21 = (v[4] - v[7]) / SQRT2
            m02 = (v[5] + v[8]) / SQRT2
            m20 = (v[5] - v[8]) / SQRT2
            return torch.stack([torch.stack([v[0], m01, m02]),
                                torch.stack([m10, v[1], m12]),
                                torch.stack([m20, m21, v[2]])])
        z = torch.zeros((), dtype=v.dtype, device=v.device)
        m01 = v[3] / SQRT2
        m12 = v[4] / SQRT2 if self.mandel == Mandel.SYMMETRIC else z
        m02 = v[5] / SQRT2 if self.mandel == Mandel.SYMMETRIC else z
        return torch.stack([torch.stack([v[0], m01, m02]),
                            torch.stack([m01, v[1], m12]),
                            torch.stack([m02, m12, v[2]])])

    def get(self, i: int, j: int) -> float:
        return float(self.as_matrix()[i, j])

    def sym_part(self) -> "Tensor2":
        if self.mandel != Mandel.GENERAL:
            return Tensor2(self.mandel, self.vec)
        return Tensor2(Mandel.SYMMETRIC, self.vec[:6])

    # -- algebra --------------------------------------------------------------

    def clone(self) -> "Tensor2":
        return Tensor2(self.mandel, self.vec)

    def scale(self, alpha) -> "Tensor2":
        return Tensor2(self.mandel, alpha * self.vec)

    def transpose(self) -> "Tensor2":
        if self.mandel == Mandel.GENERAL:
            v = self.vec
            return Tensor2(self.mandel, torch.cat([v[:6], -v[6:]]))
        return self.clone()

    def squared(self) -> "Tensor2":
        """T . T (tensor2.rs: squared)."""
        m = self.as_matrix() @ self.as_matrix()
        if self.mandel.two_dim():
            return Tensor2(Mandel.SYMMETRIC_2D, torch.stack(
                [m[0, 0], m[1, 1], m[2, 2], SQRT2 * m[0, 1]]))
        if self.mandel == Mandel.GENERAL:
            return Tensor2.from_matrix(m, Mandel.GENERAL)
        return Tensor2(Mandel.SYMMETRIC, torch.stack(
            [m[0, 0], m[1, 1], m[2, 2], SQRT2 * m[0, 1],
             SQRT2 * m[1, 2], SQRT2 * m[0, 2]]))

    def inverse(self) -> "Tensor2":
        """T^-1 (tensor2.rs: inverse); requires det != 0."""
        inv = torch.linalg.inv(self.as_matrix())
        if self.mandel == Mandel.GENERAL:
            return Tensor2.from_matrix(inv, Mandel.GENERAL)
        if self.mandel.two_dim():
            return Tensor2(Mandel.SYMMETRIC_2D, torch.stack(
                [inv[0, 0], inv[1, 1], inv[2, 2], SQRT2 * inv[0, 1]]))
        return Tensor2(Mandel.SYMMETRIC, torch.stack(
            [inv[0, 0], inv[1, 1], inv[2, 2], SQRT2 * inv[0, 1],
             SQRT2 * inv[1, 2], SQRT2 * inv[0, 2]]))

    def deviator(self) -> "Tensor2":
        """s = T - (I1/3) I (tensor2.rs: deviator)."""
        mean = (self.vec[0] + self.vec[1] + self.vec[2]) / 3.0
        return Tensor2(self.mandel, add_to_diagonal(self.vec, -mean))

    def norm(self) -> float:
        """Frobenius norm — plain Euclidean norm of the Mandel vector."""
        return float(torch.linalg.norm(self.vec))

    # -- invariants (tensor2.rs invariants section) ---------------------------

    def trace(self):
        return self.vec[0] + self.vec[1] + self.vec[2]

    def invariant_ii1(self):
        return self.trace()

    def invariant_ii2(self):
        m = self.as_matrix()
        t = self.trace()
        return 0.5 * (t * t - torch.trace(m @ m))

    def invariant_ii3(self):
        return torch.linalg.det(self.as_matrix())

    def determinant(self):
        return self.invariant_ii3()

    def invariant_jj2(self):
        """J2 = s:s / 2 of the symmetric part."""
        s = self.sym_part().deviator()
        return 0.5 * torch.sum(s.vec * s.vec)

    def invariant_jj3(self):
        s = self.sym_part().deviator()
        return torch.linalg.det(s.as_matrix())

    def invariant_sigma_m(self):
        return self.trace() / 3.0

    def invariant_sigma_d(self):
        return torch.sqrt(3.0 * torch.clamp(self.invariant_jj2(), min=0.0))

    def invariant_eps_v(self):
        return self.trace()

    def invariant_eps_d(self):
        return 2.0 * torch.sqrt(torch.clamp(self.invariant_jj2(), min=0.0)
                                / 3.0)

    def invariant_lode(self):
        """l = cos(3 theta) = (3 sqrt3 / 2) J3 / J2^1.5; NaN when J2 < tol
        (tensor2.rs: invariant_lode)."""
        jj2 = self.invariant_jj2()
        jj3 = self.invariant_jj3()
        val = 1.5 * SQRT3 * jj3 / torch.clamp(jj2, min=1e-300) ** 1.5
        return torch.where(jj2 > TOL_J2, val, math.nan)

    # -- octahedral -----------------------------------------------------------

    def octahedral_distance(self):
        return self.trace() / SQRT3

    def octahedral_radius(self):
        s = self.sym_part().deviator()
        return torch.linalg.norm(s.vec)

    # -- display --------------------------------------------------------------

    def __repr__(self):
        vec = self.vec.detach().cpu().numpy()
        return f"Tensor2({self.mandel.name}, {vec})"
