"""Linear elasticity: Mandel stiffness/compliance and stress calculation.

Counterpart of ``russell_tpu.tensor.lin_elasticity`` (reference contract:
russell_tensor/src/lin_elasticity.rs:5): D from (E, nu) with 3D /
plane-strain / plane-stress variants, built on the host and placed on
``device=`` (the card by default); calc_stress:308 (sigma = D : eps, one
matvec); compliance :390 (C = D^-1).
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.tensor.enums import Mandel
from russell_tpu_torch.tensor.tensor2 import Tensor2
from russell_tpu_torch.tensor.tensor4 import Tensor4

__all__ = ["LinElasticity"]


class LinElasticity:
    def __init__(self, young: float, poisson: float, two_dim: bool = False,
                 plane_stress: bool = False, device=None):
        self.young = young
        self.poisson = poisson
        self.plane_stress = plane_stress
        self.two_dim = two_dim or plane_stress
        self.mandel = Mandel.SYMMETRIC_2D if self.two_dim else \
            Mandel.SYMMETRIC
        self.dd = Tensor4(self.mandel, self._calc_dd(), device)

    def _calc_dd(self) -> np.ndarray:
        n = self.mandel.dim()
        ee, nu = self.young, self.poisson
        d = np.zeros((n, n))
        if self.plane_stress:
            c = ee / (1.0 - nu * nu)
            d[0, 0] = c
            d[0, 1] = c * nu
            d[1, 0] = c * nu
            d[1, 1] = c
            d[3, 3] = c * (1.0 - nu)  # Mandel: 2G slot = c(1-nu)
        else:
            c = ee / ((1.0 + nu) * (1.0 - 2.0 * nu))
            lam = c * nu
            two_g = c * (1.0 - 2.0 * nu)  # = 2G
            for i in range(3):
                for j in range(3):
                    d[i, j] = lam
                d[i, i] += two_g
            for k in range(3, n):
                d[k, k] = two_g
        return d

    def set_young_poisson(self, young: float, poisson: float):
        self.young = young
        self.poisson = poisson
        self.dd = Tensor4(self.mandel, self._calc_dd(), self.dd.device)
        return self

    def get_modulus(self) -> Tensor4:
        return self.dd

    def get_bulk_modulus(self) -> float:
        return self.young / (3.0 * (1.0 - 2.0 * self.poisson))

    def get_shear_modulus(self) -> float:
        return self.young / (2.0 * (1.0 + self.poisson))

    def calc_stress(self, eps: Tensor2) -> Tensor2:
        """sigma = D : eps (lin_elasticity.rs:308) — one Mandel matvec."""
        if eps.mandel != self.mandel:
            raise ValueError("strain tensor has the wrong Mandel basis")
        return Tensor2(self.mandel, self.dd.mat @ eps.vec)

    def calc_compliance(self) -> Tensor4:
        """C = D^-1 (lin_elasticity.rs:390). The plane-stress D is
        singular (its zz row and column are zero): ``torch.linalg.inv``
        raises ``LinAlgError`` there, where the reference returns
        non-finite values."""
        return Tensor4(self.mandel, torch.linalg.inv(self.dd.mat))

    def out_of_plane_strain(self, sigma: Tensor2) -> float:
        """ezz for plane-stress (lin_elasticity.rs), a host float."""
        if not self.plane_stress:
            raise ValueError("out-of-plane strain requires plane-stress")
        return float(-self.poisson * (sigma.vec[0] + sigma.vec[1])
                     / self.young)
