"""1-D minimization: bracketing, Brent's minimizer, line search.

Counterpart of ``russell_tpu.algo.minimize``, copied: host Python, as in
the reference, since every step calls the user's Python callback
``f(x, args)`` for one float (reference contracts:
russell_lab/src/algo/{bracket.rs, min_bracketing.rs, min_solver.rs,
line_search.rs}).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from russell_tpu_torch.algo.stats import Stats

__all__ = ["Bracket", "MinBracketing", "MinSolver", "LineSearcher",
           "line_search"]

EPS = 2.220446049250313e-16
GOLDEN = (1.0 + math.sqrt(5.0)) / 2.0


@dataclass
class Bracket:
    """(a, b, c) with fb < fa and fb < fc (bracket.rs:13)."""

    a: float
    fa: float
    b: float
    fb: float
    c: float
    fc: float


class MinBracketing:
    """Downhill bracketing from an initial guess (min_bracketing.rs:6)."""

    def __init__(self):
        self.initial_step = 1e-2
        self.n_iteration_max = 200
        self.magnification = GOLDEN
        self.stats = Stats()

    def set_enable_stats(self, value: bool):
        self.stats.enabled = value
        return self

    def get_stats(self) -> Stats:
        if not self.stats.enabled:
            raise RuntimeError("statistics tracking is disabled")
        return self.stats

    def basic(self, x_guess: float, f, args=None) -> Bracket:
        """Expands downhill until fb < fa and fb < fc
        (min_bracketing.rs:129)."""
        self.stats.reset()
        a = float(x_guess)
        b = a + self.initial_step
        fa, fb = float(f(a, args)), float(f(b, args))
        self.stats.n_function += 2
        if fb > fa:
            a, b = b, a
            fa, fb = fb, fa
        c = b + self.magnification * (b - a)
        fc = float(f(c, args))
        self.stats.n_function += 1
        for _ in range(self.n_iteration_max):
            self.stats.n_iterations += 1
            if fb < fc:
                if a > c:
                    a, c = c, a
                    fa, fc = fc, fa
                self.stats.stop_sw()
                return Bracket(a, fa, b, fb, c, fc)
            a, b = b, c
            fa, fb = fb, fc
            c = b + self.magnification * (b - a)
            fc = float(f(c, args))
            self.stats.n_function += 1
        raise RuntimeError("bracketing did not converge")


class MinSolver:
    """Brent's minimizer without derivatives (min_solver.rs:10)."""

    def __init__(self):
        self.n_iteration_max = 100
        self.tolerance = 1e-10
        self.stats = Stats()

    def set_enable_stats(self, value: bool):
        self.stats.enabled = value
        return self

    def get_stats(self) -> Stats:
        if not self.stats.enabled:
            raise RuntimeError("statistics tracking is disabled")
        return self.stats

    def brent(self, xa: float, xb: float, f, args=None) -> float:
        """Golden-section + parabolic interpolation (min_solver.rs:127;
        Brent 1973 fmin)."""
        self.stats.reset()
        cgold = 0.5 * (3.0 - math.sqrt(5.0))
        a, b = min(xa, xb), max(xa, xb)
        x = w = v = a + cgold * (b - a)
        fx = fw = fv = float(f(x, args))
        self.stats.n_function += 1
        d = e = 0.0
        for _ in range(self.n_iteration_max):
            self.stats.n_iterations += 1
            xm = 0.5 * (a + b)
            tol1 = self.tolerance * abs(x) + 1e-15
            tol2 = 2.0 * tol1
            if abs(x - xm) <= tol2 - 0.5 * (b - a):
                self.stats.error_estimate = b - a
                self.stats.stop_sw()
                return x
            use_golden = True
            if abs(e) > tol1:
                r = (x - w) * (fx - fv)
                q = (x - v) * (fx - fw)
                p = (x - v) * q - (x - w) * r
                q = 2.0 * (q - r)
                if q > 0.0:
                    p = -p
                q = abs(q)
                etemp = e
                e = d
                if not (abs(p) >= abs(0.5 * q * etemp) or p <= q * (a - x)
                        or p >= q * (b - x)):
                    d = p / q
                    u = x + d
                    if u - a < tol2 or b - u < tol2:
                        d = math.copysign(tol1, xm - x)
                    use_golden = False
            if use_golden:
                e = (b - x) if x < xm else (a - x)
                d = cgold * e
            u = x + d if abs(d) >= tol1 else x + math.copysign(tol1, d)
            fu = float(f(u, args))
            self.stats.n_function += 1
            if fu <= fx:
                if u >= x:
                    a = x
                else:
                    b = x
                v, w, x = w, x, u
                fv, fw, fx = fw, fx, fu
            else:
                if u < x:
                    a = u
                else:
                    b = u
                if fu <= fw or w == x:
                    v, w = w, u
                    fv, fw = fw, fu
                elif fu <= fv or v == x or v == w:
                    v, fv = u, fu
        raise RuntimeError("Brent's minimization did not converge")


class LineSearcher:
    """Backtracking line search with sufficient-decrease (Armijo)
    condition (line_search.rs:83)."""

    def __init__(self):
        self.max_num_iterations = 40
        self.flo = 1e-4          # sufficient decrease coefficient
        self.min_multiplier = 0.1
        self.max_multiplier = 0.5
        self.tol_step = 1e-11
        self.stats = Stats()

    def search(self, x: float, p: float, fx: float, slope: float, f,
               args=None) -> float:
        """Returns step length t along direction p (line_search.rs:169)."""
        self.stats.reset()
        if slope >= 0.0:
            raise ValueError("the slope must be negative")
        t = 1.0
        t_prev = 1.0
        f_prev = fx
        for it in range(self.max_num_iterations):
            self.stats.n_iterations += 1
            ft = float(f(x + t * p, args))
            self.stats.n_function += 1
            if ft <= fx + self.flo * t * slope:
                return t
            if it == 0:
                t_new = -slope / (2.0 * (ft - fx - slope))  # quadratic fit
            else:
                # cubic fit through (t, ft) and (t_prev, f_prev)
                r1 = ft - fx - t * slope
                r2 = f_prev - fx - t_prev * slope
                a = (r1 / t**2 - r2 / t_prev**2) / (t - t_prev)
                b = (-t_prev * r1 / t**2 + t * r2 / t_prev**2) / (t - t_prev)
                if a == 0.0:
                    t_new = -slope / (2.0 * b)
                else:
                    disc = b * b - 3.0 * a * slope
                    if disc < 0.0:
                        t_new = self.max_multiplier * t
                    else:
                        t_new = (-b + math.sqrt(disc)) / (3.0 * a)
            t_prev, f_prev = t, ft
            t = min(max(t_new, self.min_multiplier * t),
                    self.max_multiplier * t)
            if t * abs(p) < self.tol_step:
                return t
        raise RuntimeError("line search did not converge")


def line_search(x: float, p: float, fx: float, slope: float, f, args=None
                ) -> float:
    """Convenience wrapper (line_search.rs:248)."""
    return LineSearcher().search(x, p, fx, slope, f, args)
