"""Transfinite (Coons-patch) interpolation maps: reference square/cube to
curved domains.

Counterpart of ``russell_tpu.pde.transfinite``, copied (host numpy, as in
the reference).

Reference contracts: russell_pde/src/transfinite_2d.rs:23 and
transfinite_3d.rs:28. Boundary functions return position vectors;
derivative functions return the corresponding parametric derivatives.

2D: boundaries [B0(s), B1(s), B2(r), B3(r)] with r, s in [-1, 1]
    (B0 = Xmin edge, B1 = Xmax edge, B2 = Ymin edge, B3 = Ymax edge).
3D: faces [B0(s,t), B1(s,t), B2(r,t), B3(r,t), B4(r,s), B5(r,s)].
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

__all__ = ["Transfinite2d", "Transfinite3d"]


class Transfinite2d:
    def __init__(self, boundary_functions: List[Callable],
                 deriv1_boundary_functions: List[Callable],
                 deriv2_boundary_functions: Optional[List[Callable]] = None):
        if len(boundary_functions) != 4:
            raise ValueError("boundary_functions must have length 4")
        if len(deriv1_boundary_functions) != 4:
            raise ValueError("deriv1_boundary_functions must have length 4")
        if (deriv2_boundary_functions is not None
                and len(deriv2_boundary_functions) != 4):
            raise ValueError("deriv2_boundary_functions must have length 4")
        self.b = [lambda v, f=f: np.asarray(f(v), dtype=np.float64)
                  for f in boundary_functions]
        self.db = [lambda v, f=f: np.asarray(f(v), dtype=np.float64)
                   for f in deriv1_boundary_functions]
        self.ddb = None if deriv2_boundary_functions is None else [
            lambda v, f=f: np.asarray(f(v), dtype=np.float64)
            for f in deriv2_boundary_functions]
        # corners (transfinite_2d.rs:112-115)
        self.p0 = self.b[0](-1.0)
        self.p3 = self.b[0](1.0)
        self.p1 = self.b[1](-1.0)
        self.p2 = self.b[1](1.0)

    def point(self, r: float, s: float) -> np.ndarray:
        """x(r, s) by Coons-patch blending (transfinite_2d.rs:122)."""
        b0, b1 = self.b[0](s), self.b[1](s)
        b2, b3 = self.b[2](r), self.b[3](r)
        return (0.5 * ((1 - r) * b0 + (1 + r) * b1 + (1 - s) * b2
                       + (1 + s) * b3)
                - 0.25 * ((1 - r) * (1 - s) * self.p0
                          + (1 + r) * (1 - s) * self.p1
                          + (1 + r) * (1 + s) * self.p2
                          + (1 - r) * (1 + s) * self.p3))

    def point_and_derivs(self, r: float, s: float, second: bool = False):
        """(x, dx_dr, dx_ds [, d2x_dr2, d2x_ds2, d2x_drs])
        (transfinite_2d.rs:159)."""
        b0, b1 = self.b[0](s), self.b[1](s)
        b2, b3 = self.b[2](r), self.b[3](r)
        db0, db1 = self.db[0](s), self.db[1](s)
        db2, db3 = self.db[2](r), self.db[3](r)
        x = self.point(r, s)
        dx_dr = (0.5 * (-b0 + b1 + (1 - s) * db2 + (1 + s) * db3)
                 - 0.25 * (-(1 - s) * self.p0 + (1 - s) * self.p1
                           + (1 + s) * self.p2 - (1 + s) * self.p3))
        dx_ds = (0.5 * ((1 - r) * db0 + (1 + r) * db1 - b2 + b3)
                 - 0.25 * (-(1 - r) * self.p0 - (1 + r) * self.p1
                           + (1 + r) * self.p2 + (1 - r) * self.p3))
        if not second:
            return x, dx_dr, dx_ds
        if self.ddb is None:
            raise ValueError("second-derivative boundary functions are "
                             "required")
        ddb0, ddb1 = self.ddb[0](s), self.ddb[1](s)
        ddb2, ddb3 = self.ddb[2](r), self.ddb[3](r)
        d2x_dr2 = 0.5 * ((1 - s) * ddb2 + (1 + s) * ddb3)
        d2x_ds2 = 0.5 * ((1 - r) * ddb0 + (1 + r) * ddb1)
        d2x_drs = (0.5 * (-db0 + db1 - db2 + db3)
                   - 0.25 * (self.p0 - self.p1 + self.p2 - self.p3))
        return x, dx_dr, dx_ds, d2x_dr2, d2x_ds2, d2x_drs

    def get_corners(self):
        return self.p0, self.p1, self.p2, self.p3

    def triangulate(self, nr: int, ns: int):
        """(points, triangles) triangulation of the mapped domain
        (transfinite_2d.rs:281)."""
        rs = np.linspace(-1.0, 1.0, nr)
        ss = np.linspace(-1.0, 1.0, ns)
        pts = np.array([self.point(r, s) for s in ss for r in rs])
        tris = []
        for j in range(ns - 1):
            for i in range(nr - 1):
                a = i + j * nr
                tris.append([a, a + 1, a + nr])
                tris.append([a + 1, a + nr + 1, a + nr])
        return pts, np.array(tris)


class Transfinite3d:
    """Coons-volume blending with 6 face functions
    (transfinite_3d.rs:143,269)."""

    def __init__(self, face_functions: List[Callable],
                 deriv1_face_functions: Optional[List[Callable]] = None,
                 deriv2_face_functions=None):
        if len(face_functions) != 6:
            raise ValueError("boundary_functions must have length 6")
        self.f = [lambda a, b, g=g: np.asarray(g(a, b), dtype=np.float64)
                  for g in face_functions]
        self.df = deriv1_face_functions

    def point(self, r: float, s: float, t: float) -> np.ndarray:
        """Faces - edges + corners blending (transfinite_3d.rs:300-330)."""
        F = self.f
        m, p = -1.0, 1.0
        # faces
        val = 0.5 * ((1 - r) * F[0](s, t) + (1 + r) * F[1](s, t)
                     + (1 - s) * F[2](r, t) + (1 + s) * F[3](r, t)
                     + (1 - t) * F[4](r, s) + (1 + t) * F[5](r, s))
        # edges (each shared by two faces; use face restrictions)
        val -= 0.25 * ((1 - r) * (1 - s) * F[0](m, t)
                       + (1 - r) * (1 + s) * F[0](p, t)
                       + (1 + r) * (1 - s) * F[1](m, t)
                       + (1 + r) * (1 + s) * F[1](p, t)
                       + (1 - r) * (1 - t) * F[0](s, m)
                       + (1 - r) * (1 + t) * F[0](s, p)
                       + (1 + r) * (1 - t) * F[1](s, m)
                       + (1 + r) * (1 + t) * F[1](s, p)
                       + (1 - s) * (1 - t) * F[2](r, m)
                       + (1 - s) * (1 + t) * F[2](r, p)
                       + (1 + s) * (1 - t) * F[3](r, m)
                       + (1 + s) * (1 + t) * F[3](r, p))
        # corners
        val += 0.125 * ((1 - r) * (1 - s) * (1 - t) * F[0](m, m)
                        + (1 + r) * (1 - s) * (1 - t) * F[1](m, m)
                        + (1 + r) * (1 + s) * (1 - t) * F[1](p, m)
                        + (1 - r) * (1 + s) * (1 - t) * F[0](p, m)
                        + (1 - r) * (1 - s) * (1 + t) * F[0](m, p)
                        + (1 + r) * (1 - s) * (1 + t) * F[1](m, p)
                        + (1 + r) * (1 + s) * (1 + t) * F[1](p, p)
                        + (1 - r) * (1 + s) * (1 + t) * F[0](p, p))
        return val

    def point_and_derivs(self, r: float, s: float, t: float,
                         h: float = 1e-7):
        """(x, dx_dr, dx_ds, dx_dt) — derivatives by central differences of
        the blended map."""
        x = self.point(r, s, t)
        dr = (self.point(r + h, s, t) - self.point(r - h, s, t)) / (2 * h)
        ds = (self.point(r, s + h, t) - self.point(r, s - h, t)) / (2 * h)
        dt = (self.point(r, s, t + h) - self.point(r, s, t - h)) / (2 * h)
        return x, dr, ds, dt
