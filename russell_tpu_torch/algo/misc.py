"""Linear fitting, cubic roots, B-splines, and the test-function corpus.

Counterpart of ``russell_tpu.algo.misc``, copied whole: host numpy, as in
the reference.

Reference contracts: russell_lab/src/algo/{linear_fitting.rs, cubic.rs,
bspline.rs, testing.rs}.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

__all__ = ["linear_fitting", "solve_cubic", "Bspline", "TestFunction",
           "get_test_functions"]


def linear_fitting(x, y, pass_through_zero: bool = False):
    """Least-squares line fit: returns (c, m) of y = c + m x
    (linear_fitting.rs:45)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("x and y must have the same length")
    if len(x) < 2:
        raise ValueError("at least two points are required")
    if pass_through_zero:
        den = float(np.sum(x * x))
        if den == 0.0:
            raise ValueError("cannot fit: sum(x^2) is zero")
        return 0.0, float(np.sum(x * y)) / den
    n = float(len(x))
    sx, sy = float(np.sum(x)), float(np.sum(y))
    sxx, sxy = float(np.sum(x * x)), float(np.sum(x * y))
    den = n * sxx - sx * sx
    if den == 0.0:
        raise ValueError("cannot fit the data: vertical line")
    m = (n * sxy - sx * sy) / den
    c = (sy - m * sx) / n
    return c, m


def solve_cubic(a: float, b: float, c: float, d: float) -> List[float]:
    """Real roots of a x^3 + b x^2 + c x + d = 0, ascending (cubic.rs:32;
    trigonometric/Cardano method)."""
    if a == 0.0:
        raise ValueError("the cubic coefficient a must be nonzero")
    b, c, d = b / a, c / a, d / a
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    eps = 1e-14 * max(1.0, abs(p) ** 1.5, abs(q))
    if disc > eps:
        # one real root
        s = math.sqrt(disc)
        u = np.cbrt(-q / 2.0 + s)
        v = np.cbrt(-q / 2.0 - s)
        return [float(u + v + shift)]
    if abs(disc) <= eps:
        if abs(q) < 1e-300 and abs(p) < 1e-300:
            return [shift]
        u = np.cbrt(-q / 2.0)
        roots = sorted({float(2.0 * u + shift), float(-u + shift)})
        return roots
    # three distinct real roots (trigonometric)
    r = math.sqrt(-p ** 3 / 27.0)
    phi = math.acos(max(-1.0, min(1.0, -q / (2.0 * r))))
    m = 2.0 * math.sqrt(-p / 3.0)
    roots = [m * math.cos((phi + 2.0 * math.pi * k) / 3.0) + shift
             for k in range(3)]
    return sorted(roots)


class Bspline:
    """B-spline basis + curve (reference: bspline.rs:77; Piegl & Tiller
    algorithms A2.1-A2.3, A3.1-A3.2)."""

    def __init__(self, p: int, uu):
        uu = np.asarray(uu, dtype=np.float64)
        if p < 1:
            raise ValueError("the degree must be >= 1")
        if len(uu) < 2 * (p + 1):
            raise ValueError("the knot vector must have >= 2(p+1) entries")
        if np.any(np.diff(uu) < 0):
            raise ValueError("the knots must be non-decreasing")
        self.p = p
        self.uu = uu
        self.m = len(uu)
        self.n_basis = self.m - p - 1
        self.control: Optional[np.ndarray] = None
        self._basis = np.zeros(self.n_basis)
        self._derivs = None

    def num_basis(self) -> int:
        return self.n_basis

    def set_control_points(self, pp):
        pp = np.asarray(pp, dtype=np.float64)
        if pp.shape[0] != self.n_basis:
            raise ValueError("there must be m - p - 1 control points")
        self.control = pp
        return self

    def _find_span(self, u: float) -> int:
        """Knot span index (A2.1)."""
        p, uu = self.p, self.uu
        n = self.n_basis - 1
        if u >= uu[n + 1]:
            return n
        if u <= uu[p]:
            return p
        lo, hi = p, n + 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if u < uu[mid]:
                hi = mid
            else:
                lo = mid
        return lo

    def _basis_funs(self, span: int, u: float) -> np.ndarray:
        """Nonzero basis values (A2.2)."""
        p, uu = self.p, self.uu
        N = np.zeros(p + 1)
        left = np.zeros(p + 1)
        right = np.zeros(p + 1)
        N[0] = 1.0
        for j in range(1, p + 1):
            left[j] = u - uu[span + 1 - j]
            right[j] = uu[span + j] - u
            saved = 0.0
            for r in range(j):
                tmp = N[r] / (right[r + 1] + left[j - r])
                N[r] = saved + right[r + 1] * tmp
                saved = left[j - r] * tmp
            N[j] = saved
        return N

    def _basis_derivs(self, span: int, u: float, upto: int) -> np.ndarray:
        """Nonzero basis derivatives up to order `upto` (A2.3)."""
        p, uu = self.p, self.uu
        ndu = np.zeros((p + 1, p + 1))
        left = np.zeros(p + 1)
        right = np.zeros(p + 1)
        ndu[0, 0] = 1.0
        for j in range(1, p + 1):
            left[j] = u - uu[span + 1 - j]
            right[j] = uu[span + j] - u
            saved = 0.0
            for r in range(j):
                ndu[j, r] = right[r + 1] + left[j - r]
                tmp = ndu[r, j - 1] / ndu[j, r]
                ndu[r, j] = saved + right[r + 1] * tmp
                saved = left[j - r] * tmp
            ndu[j, j] = saved
        ders = np.zeros((upto + 1, p + 1))
        ders[0] = ndu[:, p]
        a = np.zeros((2, p + 1))
        for r in range(p + 1):
            s1, s2 = 0, 1
            a[0, 0] = 1.0
            for k in range(1, upto + 1):
                d = 0.0
                rk, pk = r - k, p - k
                if r >= k:
                    a[s2, 0] = a[s1, 0] / ndu[pk + 1, rk]
                    d = a[s2, 0] * ndu[rk, pk]
                j1 = 1 if rk >= -1 else -rk
                j2 = k - 1 if r - 1 <= pk else p - r
                for j in range(j1, j2 + 1):
                    a[s2, j] = (a[s1, j] - a[s1, j - 1]) / ndu[pk + 1, rk + j]
                    d += a[s2, j] * ndu[rk + j, pk]
                if r <= pk:
                    a[s2, k] = -a[s1, k - 1] / ndu[pk + 1, r]
                    d += a[s2, k] * ndu[r, pk]
                ders[k, r] = d
                s1, s2 = s2, s1
        fac = float(p)
        for k in range(1, upto + 1):
            ders[k] *= fac
            fac *= p - k
        return ders

    def calc_basis(self, u: float):
        """Fills the full basis vector at u (bspline.rs:231)."""
        self._check_u(u)
        span = self._find_span(u)
        N = self._basis_funs(span, u)
        self._basis[:] = 0.0
        self._basis[span - self.p: span + 1] = N
        return self

    def calc_basis_and_derivs(self, u: float, upto: int = 1):
        self._check_u(u)
        span = self._find_span(u)
        ders = self._basis_derivs(span, u, upto)
        self._derivs = np.zeros((upto + 1, self.n_basis))
        self._derivs[:, span - self.p: span + 1] = ders
        self._basis[:] = self._derivs[0]
        return self

    def get_basis(self, i: int) -> float:
        return float(self._basis[i])

    def get_basis_deriv(self, i: int, degree: int = 1) -> float:
        if self._derivs is None:
            raise RuntimeError("calc_basis_and_derivs must be called first")
        return float(self._derivs[degree, i])

    def recursive_basis(self, u: float, i: int) -> float:
        """Cox-de-Boor recursion (bspline.rs:294; reference check path)."""
        self._check_u(u)

        def N(i, p):
            if p == 0:
                last = (i == self.m - self.p - 2
                        and u == self.uu[self.m - self.p - 1])
                return 1.0 if (self.uu[i] <= u < self.uu[i + 1]) or last \
                    else 0.0
            d1 = self.uu[i + p] - self.uu[i]
            d2 = self.uu[i + p + 1] - self.uu[i + 1]
            t1 = (u - self.uu[i]) / d1 * N(i, p - 1) if d1 > 0 else 0.0
            t2 = (self.uu[i + p + 1] - u) / d2 * N(i + 1, p - 1) \
                if d2 > 0 else 0.0
            return t1 + t2

        return N(i, self.p)

    def calc_point(self, u: float, recursive: bool = False) -> np.ndarray:
        """Curve point C(u) (bspline.rs:316)."""
        if self.control is None:
            raise RuntimeError("set_control_points must be called first")
        if recursive:
            vals = np.array([self.recursive_basis(u, i)
                             for i in range(self.n_basis)])
            return vals @ self.control
        self.calc_basis(u)
        return self._basis @ self.control

    def calc_curve_derivs(self, u: float, upto: int = 1) -> np.ndarray:
        """dC/du ... up to order `upto` (bspline.rs:381)."""
        if self.control is None:
            raise RuntimeError("set_control_points must be called first")
        self.calc_basis_and_derivs(u, upto)
        return self._derivs @ self.control

    def get_elements(self, tolerance: float = 1e-14):
        """Non-zero-span knot intervals (bspline.rs:352)."""
        return [[i, i + 1] for i in range(self.m - 1)
                if self.uu[i + 1] - self.uu[i] > tolerance]

    def _check_u(self, u: float):
        if u < self.uu[0] - 1e-15 or u > self.uu[-1] + 1e-15:
            raise ValueError("u must be within the knot range")


@dataclass
class TestFunction:
    """Known 1-D test function with roots/minima (testing.rs:6)."""

    name: str
    f: Callable
    g: Callable          # first derivative
    h: Callable          # second derivative
    range_a: float
    range_b: float
    min1: Optional[tuple] = None     # (x, f(x))
    root1: Optional[float] = None
    root2: Optional[float] = None
    root3: Optional[float] = None
    integral: Optional[float] = None  # over [range_a, range_b]
    tol_min: float = 1e-10
    tol_root: float = 1e-10
    tol_integral: float = 1e-12


def get_test_functions() -> List[TestFunction]:
    """Corpus mirroring testing.rs:95 (same function families: polynomial,
    exponential-rational, sinusoidal)."""
    fs = []
    fs.append(TestFunction(
        name="x^2 - 1",
        f=lambda x, a=None: x * x - 1.0,
        g=lambda x, a=None: 2.0 * x,
        h=lambda x, a=None: 2.0,
        range_a=-4.0, range_b=4.0,
        min1=(0.0, -1.0), root1=-1.0, root2=1.0,
        integral=128.0 / 3.0 - 8.0))
    fs.append(TestFunction(
        name="1/(1+16x^2) - 0.09",
        f=lambda x, a=None: 1.0 / (1.0 + 16.0 * x * x) - 0.09,
        g=lambda x, a=None: -32.0 * x / (1.0 + 16.0 * x * x) ** 2,
        h=lambda x, a=None: (-32.0 * (1.0 + 16.0 * x * x)
                             + 2048.0 * x * x) / (1.0 + 16.0 * x * x) ** 3,
        range_a=-1.0, range_b=1.0,
        root1=-math.sqrt(1.0 / 0.09 - 1.0) / 4.0,
        root2=math.sqrt(1.0 / 0.09 - 1.0) / 4.0,
        integral=math.atan(4.0) / 2.0 - 0.18))
    fs.append(TestFunction(
        name="x^5 + 3x^4 - 2x^3 + x - 1",
        f=lambda x, a=None: x**5 + 3 * x**4 - 2 * x**3 + x - 1.0,
        g=lambda x, a=None: 5 * x**4 + 12 * x**3 - 6 * x**2 + 1.0,
        h=lambda x, a=None: 20 * x**3 + 36 * x**2 - 12 * x,
        range_a=-2.0, range_b=2.0,
        root1=-0.7814074218742638, root2=0.7270964646614507))
    fs.append(TestFunction(
        name="sin(x)",
        f=lambda x, a=None: math.sin(x),
        g=lambda x, a=None: math.cos(x),
        h=lambda x, a=None: -math.sin(x),
        range_a=2.0, range_b=4.0,
        root1=math.pi,
        min1=None,
        integral=math.cos(2.0) - math.cos(4.0)))
    fs.append(TestFunction(
        name="exp(x) - 2",
        f=lambda x, a=None: math.exp(x) - 2.0,
        g=lambda x, a=None: math.exp(x),
        h=lambda x, a=None: math.exp(x),
        range_a=0.0, range_b=2.0,
        root1=math.log(2.0),
        integral=math.exp(2.0) - 1.0 - 4.0))
    return fs
