"""Root finding: Chebyshev proxy + companion-matrix eigenvalues, Newton
polish, and Brent's bracketed method.

Counterpart of ``russell_tpu.algo.root_finder``, copied: host Python and
numpy, as in the reference, since every step calls the user's Python
callback ``f(x, args)`` for one float. The companion-matrix eigenvalues
are LAPACK dgeev through numpy on the host, as in the reference
(root_finder.rs:151; refine:258; root_finder_brent.rs:43).
"""

from __future__ import annotations

from typing import List

import numpy as np
from russell_tpu_torch.algo.stats import Stats

__all__ = ["RootFinder"]

EPS = 2.220446049250313e-16


class RootFinder:
    """(root_finder.rs:7)."""

    def __init__(self):
        self.tol_zero_an = 1e-13
        self.tol_abs_imaginary = 1e-8
        self.tol_abs_boundary = 1e-7
        self.newton_tol_zero_dx = 1e-13
        self.newton_tol_zero_fx = 1e-13
        self.newton_max_iterations = 15
        self.brent_tol = 1e-13
        self.brent_max_iterations = 100
        self.stats = Stats()

    def set_enable_stats(self, value: bool):
        self.stats.enabled = value
        return self

    def get_stats(self) -> Stats:
        if not self.stats.enabled:
            raise RuntimeError("statistics tracking is disabled")
        return self.stats

    # -- Chebyshev proxy ------------------------------------------------------

    def chebyshev(self, interp) -> List[float]:
        """All roots in [xa, xb] via the Chebyshev-Frobenius companion
        matrix (root_finder.rs:151)."""
        if not interp.is_ready():
            raise RuntimeError("the interpolant must be initialized first")
        nn = interp.get_degree()
        if nn == 0:
            return []
        a = interp.get_coefficients()
        an = a[nn]
        if abs(an) < self.tol_zero_an:
            raise RuntimeError("the trailing Chebyshev coefficient vanishes; "
                               "try a smaller degree N")
        xa, xb, dx = interp.get_range()
        if nn == 1:
            z = -a[0] / a[1]
            if abs(z) <= 1.0 + self.tol_abs_boundary:
                return [(xb + xa + dx * z) / 2.0]
            return []
        A = np.zeros((nn, nn))
        A[0, 1] = 1.0
        for r in range(1, nn - 1):
            A[r, r + 1] = 0.5
            A[r, r - 1] = 0.5
        A[nn - 1, :nn] = -0.5 * a[:nn] / an
        A[nn - 1, nn - 2] += 0.5
        # nonsymmetric eigenvalues on the host, as in the reference
        lam = np.linalg.eigvals(A)
        roots = []
        for lv in lam:
            if abs(lv.imag) < self.tol_abs_imaginary:
                z = lv.real
                if abs(z) <= 1.0 + self.tol_abs_boundary:
                    x = (xb + xa + dx * z) / 2.0
                    roots.append(min(xb, max(xa, float(x))))
        roots.sort()
        return roots

    def refine(self, roots, xa: float, xb: float, f, args=None):
        """Newton polish with central-difference derivative
        (root_finder.rs:258)."""
        if len(roots) == 0:
            raise RuntimeError("at least one root is required")
        h = np.sqrt(EPS)
        for i, xr in enumerate(roots):
            x = float(xr)
            converged = False
            for _ in range(self.newton_max_iterations):
                fx = float(f(x, args))
                self.stats.n_function += 1
                if abs(fx) < self.newton_tol_zero_fx:
                    converged = True
                    break
                dfdx = (float(f(min(xb, x + h), args))
                        - float(f(max(xa, x - h), args))) / (
                    min(xb, x + h) - max(xa, x - h))
                self.stats.n_function += 2
                if abs(dfdx) < 1e-300:
                    break
                dx = fx / dfdx
                if abs(dx) < self.newton_tol_zero_dx:
                    converged = True
                    x -= dx
                    break
                x -= dx
                x = min(xb, max(xa, x))
            if not converged:
                raise RuntimeError("Newton's method did not converge")
            roots[i] = x
        return roots

    # -- Brent ----------------------------------------------------------------

    def brent(self, xa: float, xb: float, f, args=None) -> float:
        """Brent's method for a bracketed root
        (root_finder_brent.rs:43; Brent 1973 zeroin)."""
        a, b = float(xa), float(xb)
        fa, fb = float(f(a, args)), float(f(b, args))
        self.stats.n_function += 2
        if fa * fb > 0.0:
            raise ValueError("f(xa) and f(xb) must have different signs")
        if fa == 0.0:
            return a
        if fb == 0.0:
            return b
        c, fc = a, fa
        d = e = b - a
        for _ in range(self.brent_max_iterations):
            self.stats.n_iterations += 1
            if abs(fc) < abs(fb):
                a, b, c = b, c, b
                fa, fb, fc = fb, fc, fb
            tol = 2.0 * EPS * abs(b) + 0.5 * self.brent_tol
            m = 0.5 * (c - b)
            if abs(m) <= tol or fb == 0.0:
                return b
            if abs(e) < tol or abs(fa) <= abs(fb):
                d = e = m  # bisection
            else:
                s = fb / fa
                if a == c:
                    p = 2.0 * m * s
                    q = 1.0 - s
                else:
                    q = fa / fc
                    r = fb / fc
                    p = s * (2.0 * m * q * (q - r) - (b - a) * (r - 1.0))
                    q = (q - 1.0) * (r - 1.0) * (s - 1.0)
                if p > 0.0:
                    q = -q
                else:
                    p = -p
                if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                    e, d = d, p / q  # accept interpolation
                else:
                    d = e = m  # bisection
            a, fa = b, fb
            b += d if abs(d) > tol else (tol if m > 0 else -tol)
            fb = float(f(b, args))
            self.stats.n_function += 1
            if (fb > 0.0) == (fc > 0.0):
                c, fc = a, fa
                d = e = b - a
        raise RuntimeError("Brent's method did not converge")
