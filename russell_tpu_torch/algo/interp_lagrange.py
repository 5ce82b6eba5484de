"""Barycentric Lagrange interpolation + differentiation matrices, in
PyTorch.

Counterpart of ``russell_tpu.algo.interp_lagrange``. Reference
contract: russell_lab/src/algo/interp_lagrange.rs — grid choice
(Uniform / ChebyshevGauss / ChebyshevGaussLobatto), barycentric lambda
weights with optional eta (log-sum) normalization for large N, psi/eval/
eval_deriv1/eval_deriv2, and the D1/D2 differentiation matrices with the
negative-sum trick (these feed the PDE spectral collocation, spc_*.rs).

Weights and D matrices are dense host numpy arrays computed vectorized,
as in the reference; ``eval`` is the barycentric formula in torch ops on
the device of ``uu`` (the host for numpy input).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from russell_tpu_torch.core._place import host
from russell_tpu_torch.math.chebyshev import (chebyshev_gauss_points,
                                              chebyshev_lobatto_points)

__all__ = ["InterpGrid", "InterpParams", "InterpLagrange"]


class InterpGrid(enum.Enum):
    """Grid type (interp_lagrange.rs:10)."""

    UNIFORM = "uniform"
    CHEBYSHEV_GAUSS = "chebyshev_gauss"
    CHEBYSHEV_GAUSS_LOBATTO = "chebyshev_gauss_lobatto"


@dataclass
class InterpParams:
    """(interp_lagrange.rs:18)."""

    grid_type: InterpGrid = InterpGrid.CHEBYSHEV_GAUSS_LOBATTO
    no_eta_normalization: bool = False
    eta_cutoff: int = 700
    lebesgue_estimate_nstation: int = 10000
    error_estimate_nstation: int = 1000

    def validate(self):
        if self.lebesgue_estimate_nstation < 2:
            raise ValueError("lebesgue_estimate_nstation must be >= 2")
        if self.error_estimate_nstation < 2:
            raise ValueError("error_estimate_nstation must be >= 2")


class InterpLagrange:
    """Barycentric interpolant over [-1, 1] (interp_lagrange.rs:249)."""

    def __init__(self, nn: int, params: InterpParams | None = None):
        if nn < 1 or nn > 2048:
            raise ValueError("the polynomial degree must be in [1, 2048]")
        par = params or InterpParams()
        par.validate()
        self.nn = nn
        self.params = par
        self.npoint = nn + 1
        if par.grid_type == InterpGrid.UNIFORM:
            self.xx = np.linspace(-1.0, 1.0, self.npoint)
        elif par.grid_type == InterpGrid.CHEBYSHEV_GAUSS:
            self.xx = np.asarray(chebyshev_gauss_points(nn))
        else:
            self.xx = np.asarray(chebyshev_lobatto_points(nn))

        diff = self.xx[:, None] - self.xx[None, :]
        np.fill_diagonal(diff, 1.0)
        if par.no_eta_normalization:
            self.eta = None
            self.lam = 1.0 / np.prod(diff, axis=1)
        else:
            # eta_j = sum_k ln|x_j - x_k| (interp_lagrange.rs:354)
            self.eta = np.sum(np.log(np.abs(diff)), axis=1)
            nnf = float(nn)
            j = np.arange(self.npoint)
            aj = np.where((j + nn) % 2 == 0, 1.0, -1.0)
            mj = -self.eta
            if nn > par.eta_cutoff:
                c = 2.0 ** (nnf / 3.0)
                c2 = 2.0 ** (nnf / 3.0 - 1.0) / nnf
                bj = np.exp(mj / 3.0)
                self.lam = aj * bj / c * (bj / c) * (bj / c2)
            else:
                c0 = 2.0 ** (nnf - 1.0) / nnf
                self.lam = aj * np.exp(mj) / c0
        assert np.all(np.isfinite(self.lam))
        self._dd1 = None
        self._dd2 = None

    # -- evaluation -----------------------------------------------------------

    def psi(self, j: int, x: float) -> float:
        """j-th barycentric cardinal polynomial at x (interp_lagrange.rs:470)."""
        if j > self.nn:
            raise ValueError("j must be in 0..=N")
        if x < -1.0 or x > 1.0:
            raise ValueError("x must be in [-1, 1]")
        d = x - self.xx
        hit = np.abs(d) < 1e-15
        if np.any(hit):
            return 1.0 if hit[j] else 0.0
        terms = self.lam / d
        return float(terms[j] / np.sum(terms))

    def eval(self, x, uu):
        """I{f}(x) by the second barycentric formula (interp_lagrange.rs:531);
        a 0-d f64 tensor on the device of ``uu``."""
        uu = torch.as_tensor(uu).to(torch.float64)
        dev = uu.device
        x = torch.as_tensor(x, dtype=torch.float64, device=dev)
        xx = torch.as_tensor(self.xx, device=dev)
        lam = torch.as_tensor(self.lam, device=dev)
        d = x - xx
        hit = torch.abs(d) < 1e-15
        any_hit = torch.any(hit)
        ds = torch.where(hit, 1.0, d)
        terms = lam / ds
        interp = torch.sum(terms * uu) / torch.sum(terms)
        exact = torch.sum(torch.where(hit, uu, 0.0))
        return torch.where(any_hit, exact, interp)

    def eval_deriv1(self, x, uu):
        """dI{f}/dx at x (interp_lagrange.rs:606), on the host (a tensor
        ``uu`` of any device is copied there)."""
        x = float(x)
        uu = host(uu)
        d = x - self.xx
        hit = np.abs(d) < 1e-15
        if np.any(hit):
            # x is grid point xk: use D1 row formula on the fly
            k = int(np.argmax(hit))
            self.calc_dd1_matrix()
            return float(self._dd1[k] @ uu)
        terms = self.lam / d
        s = np.sum(terms)
        p = np.sum(terms * uu) / s
        # derivative of barycentric form
        t2 = terms / d
        return float((p * np.sum(t2) - np.sum(t2 * uu)) / s)

    def eval_deriv2(self, x, uu):
        """d²I{f}/dx² at x (interp_lagrange.rs:725), on the host (a
        tensor ``uu`` of any device is copied there)."""
        x = float(x)
        uu = host(uu)
        d = x - self.xx
        hit = np.abs(d) < 1e-15
        if np.any(hit):
            k = int(np.argmax(hit))
            self.calc_dd2_matrix()
            return float(self._dd2[k] @ uu)
        # differentiate the barycentric ratio twice (stable rational form)
        w = self.lam / d
        s0 = np.sum(w)
        s1 = np.sum(w / d)
        s2 = np.sum(w / d ** 2)
        u0 = np.sum(w * uu)
        u1 = np.sum(w * uu / d)
        u2 = np.sum(w * uu / d ** 2)
        p = u0 / s0
        dp = (p * s1 - u1) / s0
        return float((2.0 * u2 + 2.0 * s1 * dp - 2.0 * s2 * p) / s0)

    # -- differentiation matrices --------------------------------------------

    def calc_dd1_matrix(self):
        """D1[k,j] = dL_j/dx(x_k) with negative-sum trick
        (interp_lagrange.rs:828)."""
        if self._dd1 is not None:
            return
        n = self.npoint
        dx = self.xx[:, None] - self.xx[None, :]
        np.fill_diagonal(dx, 1.0)
        if self.params.no_eta_normalization or self.eta is None:
            r = self.lam[None, :] / self.lam[:, None]
        else:
            k = np.arange(n)
            sgn = np.where((k[:, None] + k[None, :]) % 2 == 0, 1.0, -1.0)
            r = sgn * np.exp(self.eta[:, None] - self.eta[None, :])
        d1 = r / dx
        np.fill_diagonal(d1, 0.0)
        np.fill_diagonal(d1, -np.sum(d1, axis=1))
        self._dd1 = d1

    def calc_dd2_matrix(self):
        """D2 from D1 via the recursion (Eqs 9/13 of Costa-Don;
        interp_lagrange.rs:909)."""
        self.calc_dd1_matrix()
        if self._dd2 is not None:
            return
        n = self.npoint
        dx = self.xx[:, None] - self.xx[None, :]
        np.fill_diagonal(dx, 1.0)
        diag = np.diag(self._dd1)
        d2 = 2.0 * self._dd1 * (diag[:, None] - 1.0 / dx)
        np.fill_diagonal(d2, 0.0)
        np.fill_diagonal(d2, -np.sum(d2, axis=1))
        self._dd2 = d2

    def get_dd1(self) -> np.ndarray:
        if self._dd1 is None:
            raise RuntimeError("calc_dd1_matrix must be called first")
        return self._dd1

    def get_dd2(self) -> np.ndarray:
        if self._dd2 is None:
            raise RuntimeError("calc_dd2_matrix must be called first")
        return self._dd2

    # -- diagnostics ----------------------------------------------------------

    def estimate_lebesgue_constant(self) -> float:
        """Lambda_N estimate over a fine station sweep
        (interp_lagrange.rs:934)."""
        ns = self.params.lebesgue_estimate_nstation
        xs = np.linspace(-1.0, 1.0, ns)
        d = xs[:, None] - self.xx[None, :]
        hit = np.abs(d) < 1e-15
        d = np.where(hit, 1.0, d)
        terms = self.lam[None, :] / d
        num = np.sum(np.abs(terms), axis=1)
        den = np.abs(np.sum(terms, axis=1))
        vals = num / den
        vals[np.any(hit, axis=1)] = 1.0
        return float(np.max(vals))

    def estimate_max_error(self, f, args=None) -> float:
        """max |f(x) - I{f}(x)| over error_estimate_nstation points."""
        uu = np.array([f(x, args) for x in self.xx])
        xs = np.linspace(-1.0, 1.0, self.params.error_estimate_nstation)
        d = xs[:, None] - self.xx[None, :]
        hit = np.abs(d) < 1e-15
        terms = self.lam[None, :] / np.where(hit, 1.0, d)
        vals = (terms @ uu) / np.sum(terms, axis=1)
        row_hit = np.any(hit, axis=1)
        vals[row_hit] = (np.where(hit, uu[None, :], 0.0).sum(axis=1))[row_hit]
        fs = np.array([f(x, args) for x in xs])
        return float(np.max(np.abs(fs - vals)))

    # -- getters --------------------------------------------------------------

    def get_degree(self) -> int:
        return self.nn

    def get_grid_type(self) -> InterpGrid:
        return self.params.grid_type

    def get_points(self) -> np.ndarray:
        return self.xx

    def get_xrange(self):
        return -1.0, 1.0

    def get_lambda(self) -> np.ndarray:
        return self.lam
