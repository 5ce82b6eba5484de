"""Metric terms of a curvilinear mapping.

Counterpart of ``russell_tpu.pde.metrics``, copied (host numpy, as in
the reference).

Reference contract: russell_pde/src/metrics.rs:20 — covariant/
contravariant base vectors, metric tensors, Christoffel symbols of the
second kind, and the L-coefficients for the mapped Laplacian
(Lᵏ = Γᵏᵢⱼ gⁱʲ).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Metrics"]


class Metrics:
    def __init__(self, ndim: int, homogeneous: bool):
        self.ndim = ndim
        self.homogeneous = homogeneous
        self.g_cov = np.zeros((ndim, ndim))  # rows: g_i
        self.g_ctr = np.zeros((ndim, ndim))  # rows: g^i
        self.g_mat = np.zeros((ndim, ndim))
        self.gg_mat = np.zeros((ndim, ndim))
        self.christoffel_second = (None if homogeneous
                                   else np.zeros((ndim, ndim, ndim)))

    def calculate_2d(self, dx_dr, dx_ds, d2x_dr2=None, d2x_ds2=None,
                     d2x_drs=None) -> float:
        if self.ndim != 2:
            raise ValueError("calculate_2d only works for ndim = 2")
        if not self.homogeneous and (d2x_dr2 is None or d2x_ds2 is None
                                     or d2x_drs is None):
            raise ValueError("second derivatives must be provided for "
                             "non-homogeneous metrics")
        return self._calculate([dx_dr, dx_ds],
                               None if self.homogeneous else
                               [[d2x_dr2, d2x_drs], [d2x_drs, d2x_ds2]])

    def calculate_3d(self, dx_dr, dx_ds, dx_dt, d2x_dr2=None, d2x_ds2=None,
                     d2x_dt2=None, d2x_drs=None, d2x_drt=None,
                     d2x_dst=None) -> float:
        if self.ndim != 3:
            raise ValueError("calculate_3d only works for ndim = 3")
        if not self.homogeneous and any(
                v is None for v in (d2x_dr2, d2x_ds2, d2x_dt2, d2x_drs,
                                    d2x_drt, d2x_dst)):
            raise ValueError("second derivatives must be provided for "
                             "non-homogeneous metrics")
        cc = None if self.homogeneous else [
            [d2x_dr2, d2x_drs, d2x_drt],
            [d2x_drs, d2x_ds2, d2x_dst],
            [d2x_drt, d2x_dst, d2x_dt2]]
        return self._calculate([dx_dr, dx_ds, dx_dt], cc)

    def _calculate(self, covs, christoffel_vectors) -> float:
        nd = self.ndim
        for i, v in enumerate(covs):
            self.g_cov[i] = np.asarray(v, dtype=np.float64)
        self.g_mat = self.g_cov @ self.g_cov.T
        g = float(np.linalg.det(self.g_mat))
        self.gg_mat = np.linalg.inv(self.g_mat)
        self.g_ctr = self.gg_mat @ self.g_cov
        if not self.homogeneous:
            for k in range(nd):
                for i in range(nd):
                    for j in range(nd):
                        cij = np.asarray(christoffel_vectors[i][j],
                                         dtype=np.float64)
                        self.christoffel_second[k, i, j] = float(
                            cij @ self.g_ctr[k])
        return g

    def ell_coefficient_for_laplacian(self, k: int) -> float:
        """Lᵏ = Γᵏᵢⱼ gⁱʲ (metrics.rs:330)."""
        return float(np.sum(self.christoffel_second[k] * self.gg_mat))
