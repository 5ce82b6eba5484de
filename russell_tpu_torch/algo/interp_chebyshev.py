"""Chebyshev interpolation with adaptive degree selection.

Counterpart of ``russell_tpu.algo.interp_chebyshev`` (reference contract:
russell_lab/src/algo/interp_chebyshev.rs — Chebyshev-Gauss-Lobatto grid,
coefficient computation by the discrete cosine sum, Clenshaw evaluation,
and the adaptive strategy: raise the degree until the last two expansion
coefficients fall below tol, then keep N-2, interp_chebyshev.rs:387-474).

The grids, the user's callbacks and the coefficients are host numpy, as
in the reference. ``eval`` and ``eval_using_trig`` follow the device rule
of ``core/_place.py``: a tensor's device, else ``device=`` (the card by
default). The class's own host loops (``get_xy_data``,
``estimate_max_error``, ``adapt_data``'s refit) call ``eval`` on the CPU,
as the reference calls its own.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.core._place import div, f64, host, place

__all__ = ["InterpChebyshev"]

TOL_RANGE = 1e-5


def _cgl_cos_points_rev(nn: int) -> np.ndarray:
    """cos(pi k / N), k = 0..N (from +1 down to -1)."""
    return np.cos(np.pi * np.arange(nn + 1) / nn)


def _coefficients(uu_rev: np.ndarray) -> np.ndarray:
    """Chebyshev-Gauss-Lobatto expansion coefficients
    (interp_chebyshev.rs:595: a_j = sum_k 2 U_k cos(pi jk/N)/(q_j q_k N))."""
    nn = len(uu_rev) - 1
    j = np.arange(nn + 1)
    q = np.where((j == 0) | (j == nn), 2.0, 1.0)
    cosm = np.cos(np.pi * np.outer(j, j) / nn)
    return (cosm @ (uu_rev / q)) * 2.0 / (q * nn)


class InterpChebyshev:
    """Adaptive Chebyshev interpolant on [xa, xb]
    (interp_chebyshev.rs:51)."""

    @staticmethod
    def points(nn: int) -> np.ndarray:
        from russell_tpu_torch.math.chebyshev import chebyshev_lobatto_points
        return np.asarray(chebyshev_lobatto_points(nn))

    def __init__(self, nn_max: int, xa: float, xb: float):
        if xb <= xa + TOL_RANGE:
            raise ValueError("xb must be greater than xa + tolerance")
        self.nn_max = nn_max + 2  # adapt_function subtracts 2 at the end
        self.nn = 0
        self.xa = float(xa)
        self.xb = float(xb)
        self.dx = self.xb - self.xa
        self.a = np.zeros(self.nn_max + 1)
        self.constant_fx = 0.0
        self.ready = False

    # -- setters --------------------------------------------------------------

    def _eval_grid(self, nn, f, args):
        z_rev = _cgl_cos_points_rev(nn)
        xs = (self.xb + self.xa + self.dx * z_rev) / 2.0
        return np.array([float(f(x, args)) for x in xs])

    def set_function(self, nn: int, f, args=None):
        """Sets data by evaluating f at the CGL grid
        (interp_chebyshev.rs:163)."""
        if nn > self.nn_max:
            raise ValueError("nn must be <= nn_max")
        self.nn = nn
        if nn == 0:
            self.constant_fx = float(f((self.xa + self.xb) / 2.0, args))
        else:
            uu_rev = self._eval_grid(nn, f, args)
            self.a = np.zeros(self.nn_max + 1)
            self.a[: nn + 1] = _coefficients(uu_rev)
        self.ready = True
        return self

    def set_data(self, uu):
        """Data at CGL points (ascending grid; interp_chebyshev.rs:227)."""
        uu = np.asarray(host(uu), dtype=np.float64)
        npnt = len(uu)
        if npnt < 1:
            raise ValueError("the number of points must be >= 1")
        nn = npnt - 1
        if nn > self.nn_max:
            raise ValueError("nn must be <= nn_max")
        self.nn = nn
        if nn == 0:
            self.constant_fx = float(uu[0])
        else:
            self.a = np.zeros(self.nn_max + 1)
            self.a[: nn + 1] = _coefficients(uu[::-1])
        self.ready = True
        return self

    def get_xy_data(self):
        """(X, U) of the current grid (interp_chebyshev.rs:329): host."""
        if not self.ready:
            raise RuntimeError("the data or function must be set first")
        z = np.sort(np.cos(np.pi * np.arange(self.nn + 1) / max(self.nn, 1)))
        xs = (self.xb + self.xa + self.dx * z) / 2.0
        us = np.array(self.eval(xs, device="cpu").expand(len(xs)))
        return xs, us

    # -- adaptive -------------------------------------------------------------

    def adapt_function(self, tol: float, f, args=None):
        """Adaptive degree: stop when the last two coefficients < tol
        (interp_chebyshev.rs:387)."""
        an_prev = 0.0
        for nn in range(1, self.nn_max + 1):
            uu_rev = self._eval_grid(nn, f, args)
            a = _coefficients(uu_rev)
            an = a[nn]
            if nn > 1 and abs(an_prev) < tol and abs(an) < tol:
                self.set_function(nn - 2, f, args)
                return self
            an_prev = an
        raise RuntimeError("adaptive interpolation did not converge")

    def adapt_data(self, tol: float, uu):
        """Adaptive interpolation of discrete data
        (interp_chebyshev.rs:450)."""
        uu = np.asarray(host(uu), dtype=np.float64)
        npnt = len(uu)
        if npnt < 1:
            raise ValueError("the number of points must be >= 1")
        nn = npnt - 1
        if nn > self.nn_max:
            raise ValueError("nn must be <= nn_max")
        fit = InterpChebyshev(nn, self.xa, self.xb)
        fit.set_data(uu)
        return self.adapt_function(
            tol, lambda x, _: float(fit.eval(x, device="cpu")))

    # -- evaluation -----------------------------------------------------------

    def eval(self, x, device=None):
        """Clenshaw evaluation (interp_chebyshev.rs:476), in torch ops on
        ``x``'s device (``device=`` for a float, list or numpy array)."""
        if not self.ready:
            raise RuntimeError("the data or function must be set first")
        dev = place(x, device=device)
        if self.nn == 0:
            return torch.tensor(self.constant_fx, dtype=torch.float64,
                                device=dev)
        x = f64(x, dev)
        z = torch.clamp(div(2.0 * x - self.xb - self.xa, self.dx), -1.0, 1.0)
        z2 = 2.0 * z
        bk = torch.zeros_like(z)
        bk1 = torch.zeros_like(z)
        for k in range(self.nn, 0, -1):
            bk, bk1 = z2 * bk - bk1 + float(self.a[k]), bk
        return bk * z - bk1 + float(self.a[0])

    def eval_using_trig(self, x, device=None):
        """Trigonometric evaluation (interp_chebyshev.rs:499), in torch ops
        on ``x``'s device (``device=`` for a float, list or numpy array)."""
        if not self.ready:
            raise RuntimeError("the data or function must be set first")
        dev = place(x, device=device)
        if self.nn == 0:
            return torch.tensor(self.constant_fx, dtype=torch.float64,
                                device=dev)
        from russell_tpu_torch.math.chebyshev import chebyshev_tn
        x = f64(x, dev)
        z = torch.clamp(div(2.0 * x - self.xb - self.xa, self.dx), -1.0, 1.0)
        total = torch.zeros_like(z)
        for k in range(self.nn + 1):
            total = total + float(self.a[k]) * chebyshev_tn(k, z)
        return total

    def estimate_max_error(self, nstation: int, f, args=None) -> float:
        """max |f - interpolant| over ``nstation`` points: host."""
        xs = np.linspace(self.xa, self.xb, nstation)
        us = self.eval(xs, device="cpu").expand(len(xs)).tolist()
        return max(abs(float(f(x, args)) - u) for x, u in zip(xs, us))

    # -- getters --------------------------------------------------------------

    def get_degree(self) -> int:
        return self.nn

    def get_range(self):
        return self.xa, self.xb, self.dx

    def get_coefficients(self) -> np.ndarray:
        return self.a

    def is_ready(self) -> bool:
        return self.ready
