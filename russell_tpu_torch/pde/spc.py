"""Spectral collocation solvers (Chebyshev-Gauss-Lobatto grids), on the
port's LinSolver.

Counterpart of ``russell_tpu.pde.spc``. Reference contracts:
russell_pde/src/spc_1d.rs and spc_2d.rs:130 —
Lagrange D1/D2 differentiation matrices, domain mapping from [-1,1]^d,
Neumann rows replaced by flux equations -k dphi/dn = wn (so the source is
NOT added on those rows — spc_2d.rs:766), SPS/LMM strategies, flow-vector
post-processing (q = -k grad phi via D1).

The operator is a dense tensor-product matrix assembled with kron on the
host, as in the reference; the solve runs through ``LinSolver`` (DENSE:
``torch.linalg``'s LU) on the solver's ``device`` (the card unless the
caller names another) and returns a host numpy array.
"""

from __future__ import annotations

import numpy as np

import russell_tpu_torch
from russell_tpu_torch.algo.interp_lagrange import InterpLagrange
from russell_tpu_torch.pde.bcs import (EssentialBcs1d, EssentialBcs2d,
                                       NaturalBcs1d, NaturalBcs2d)
from russell_tpu_torch.pde.enums import Side
from russell_tpu_torch.pde.equation_handler import EquationHandler
from russell_tpu_torch.pde.grid import Grid1d, Grid2d
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import Genie
from russell_tpu_torch.sparse.lin_solver import LinSolver

__all__ = ["Spc1d", "Spc2d"]


def _solve_dense(K: np.ndarray, rhs: np.ndarray, genie: Genie,
                 device) -> np.ndarray:
    """x of K x = ``rhs`` through a LinSolver on ``device`` (AUTO means
    DENSE here, as in the reference), as a host array."""
    solver = LinSolver(genie if genie != Genie.AUTO else Genie.DENSE, device)
    solver.factorize(CooMatrix.from_dense(K))
    return solver.solve(rhs).cpu().numpy()


class Spc2d:
    """(spc_2d.rs:130): -kx d2/dx2 - ky d2/dy2 + alpha on CGL^2; solves on
    ``device``."""

    def __init__(self, xmin, xmax, ymin, ymax, nx: int, ny: int,
                 ebcs: EssentialBcs2d, nbcs: NaturalBcs2d,
                 kx: float, ky: float, device="cuda"):
        self.device = russell_tpu_torch.device(device)
        if nx < 2 or ny < 2:
            raise ValueError("nx and ny must be >= 2")
        if nx - 1 > 2048 or ny - 1 > 2048:
            raise ValueError("the maximum allowed polynomial degree is 2048")
        if ebcs.periodic_along_x or ebcs.periodic_along_y:
            raise ValueError("essential BCs cannot be periodic")
        self.xmin, self.xmax = float(xmin), float(xmax)
        self.ymin, self.ymax = float(ymin), float(ymax)
        self.grid = Grid2d.new_chebyshev_gauss_lobatto(nx, ny)
        self.ebcs = ebcs
        self.nbcs = nbcs
        self.mkx, self.mky = -kx, -ky
        self.equations = EquationHandler(self.grid.size())
        self.equations.recompute(ebcs.get_nodes(self.grid))
        self.interp_x = InterpLagrange(nx - 1)
        self.interp_y = InterpLagrange(ny - 1)
        self.interp_x.calc_dd1_matrix()
        self.interp_x.calc_dd2_matrix()
        self.interp_y.calc_dd1_matrix()
        self.interp_y.calc_dd2_matrix()
        self.genie = Genie.DENSE

    def set_solver_options(self, genie: Genie):
        self.genie = genie

    def map_coord(self, r: float, s: float):
        x = (self.xmax + self.xmin + (self.xmax - self.xmin) * r) / 2.0
        y = (self.ymax + self.ymin + (self.ymax - self.ymin) * s) / 2.0
        return x, y

    # -- operator -------------------------------------------------------------

    def _full_matrix(self, alpha: float) -> np.ndarray:
        """Dense K over all equations with Neumann flux rows substituted
        (spc_2d.rs:531)."""
        nx, ny = self.grid.nx(), self.grid.ny()
        neq = nx * ny
        d1r = self.interp_x.get_dd1()
        d1s = self.interp_y.get_dd1()
        d2r = self.interp_x.get_dd2()
        d2s = self.interp_y.get_dd2()
        dr_dx = 2.0 / (self.xmax - self.xmin)
        ds_dy = 2.0 / (self.ymax - self.ymin)
        cx = dr_dx * dr_dx
        cy = ds_dy * ds_dy
        Ix, Iy = np.eye(nx), np.eye(ny)
        # m = i + j*nx: kron(row-major over j) => kron(Ay, Ax)
        K = (self.mkx * cx * np.kron(Iy, d2r)
             + self.mky * cy * np.kron(d2s, Ix)
             + alpha * np.eye(neq))
        # Neumann rows: replace PDE row by flux equation
        i = np.arange(neq) % nx
        j = np.arange(neq) // nx
        for m in range(neq):
            ii, jj = int(i[m]), int(j[m])
            if self.nbcs.enabled_ij(ii, jj, self.grid):
                row = np.zeros(neq)
                if ii == 0:
                    cols = np.arange(nx) + jj * nx
                    row[cols] += -self.mkx * d1r[ii, :] * dr_dx
                if ii == nx - 1:
                    cols = np.arange(nx) + jj * nx
                    row[cols] += self.mkx * d1r[ii, :] * dr_dx
                if jj == 0:
                    cols = ii + np.arange(ny) * nx
                    row[cols] += -self.mky * d1s[jj, :] * ds_dy
                if jj == ny - 1:
                    cols = ii + np.arange(ny) * nx
                    row[cols] += self.mky * d1s[jj, :] * ds_dy
                K[m, :] = row
        return K

    def get_matrices_sps(self, alpha: float, extra_nnz: int = 0):
        """(kk_bar, kk_check) CooMatrix pair (spc_2d.rs:531)."""
        eq = self.equations
        K = self._full_matrix(alpha)
        U = np.array(eq.unknown(), dtype=np.int64)
        P = np.array(eq.prescribed(), dtype=np.int64)
        kk_bar = CooMatrix.from_dense(K[np.ix_(U, U)])
        if len(P) == 0:
            return kk_bar, CooMatrix(1, 1, 1)
        kk_check = CooMatrix.from_dense(K[np.ix_(U, P)])
        return kk_bar, kk_check

    def get_vectors_sps(self, source):
        """(a_bar, a_check, f_bar) with Neumann rows carrying wn, NOT the
        source (spc_2d.rs:750)."""
        eq = self.equations
        a_bar = np.zeros(eq.nu())
        a_check = np.zeros(eq.np())
        f_bar = np.zeros(eq.nu())
        for m in eq.unknown():
            iu = eq.iu(m)
            r, s = self.grid.coord(m)
            x, y = self.map_coord(r, s)
            if self.grid.on_boundary(m):
                if self.grid.is_xmin(m):
                    f_bar[iu] += self.nbcs.functions[0](x, y)
                if self.grid.is_xmax(m):
                    f_bar[iu] += self.nbcs.functions[1](x, y)
                if self.grid.is_ymin(m):
                    f_bar[iu] += self.nbcs.functions[2](x, y)
                if self.grid.is_ymax(m):
                    f_bar[iu] += self.nbcs.functions[3](x, y)
            else:
                f_bar[iu] = source(x, y)
        for index in range(4):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    r, s = self.grid.coord(m)
                    x, y = self.map_coord(r, s)
                    a_check[eq.ip(m)] = self.ebcs.functions[index](x, y)
        return a_bar, a_check, f_bar

    def get_joined_vector_sps(self, a_bar, a_check) -> np.ndarray:
        eq = self.equations
        a = np.zeros(eq.neq())
        for m in eq.unknown():
            a[m] = a_bar[eq.iu(m)]
        for m in eq.prescribed():
            a[m] = a_check[eq.ip(m)]
        return a

    def solve_sps(self, alpha: float, source) -> np.ndarray:
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        K = self._full_matrix(alpha)
        U = np.array(eq.unknown(), dtype=np.int64)
        P = np.array(eq.prescribed(), dtype=np.int64)
        _, a_check, f_bar = self.get_vectors_sps(source)
        rhs = f_bar
        if len(P):
            rhs = f_bar - K[np.ix_(U, P)] @ a_check
        a_bar = _solve_dense(K[np.ix_(U, U)], rhs, self.genie,
                             self.device)
        return self.get_joined_vector_sps(a_bar, a_check)

    def solve_lmm(self, alpha: float, source) -> np.ndarray:
        """Saddle system with Lagrange multipliers (spc_2d.rs:379)."""
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        neq, nlag, ndim = self.get_dims_lmm()
        K = self._full_matrix(alpha)
        M = np.zeros((ndim, ndim))
        M[:neq, :neq] = K
        for m in eq.prescribed():
            ip = eq.ip(m)
            M[neq + ip, m] = 1.0
            M[m, neq + ip] = 1.0
        ff = np.zeros(ndim)
        for m in range(neq):
            r, s = self.grid.coord(m)
            x, y = self.map_coord(r, s)
            if self.grid.on_boundary(m):
                if self.grid.is_xmin(m):
                    ff[m] += self.nbcs.functions[0](x, y)
                if self.grid.is_xmax(m):
                    ff[m] += self.nbcs.functions[1](x, y)
                if self.grid.is_ymin(m):
                    ff[m] += self.nbcs.functions[2](x, y)
                if self.grid.is_ymax(m):
                    ff[m] += self.nbcs.functions[3](x, y)
            else:
                ff[m] = source(x, y)
        for index in range(4):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    r, s = self.grid.coord(m)
                    x, y = self.map_coord(r, s)
                    ff[neq + eq.ip(m)] = self.ebcs.functions[index](x, y)
        sol = _solve_dense(M, ff, self.genie, self.device)
        return sol[:neq]

    def calculate_flow_vectors(self, a):
        """(qx, qy) = -k grad(phi) at all nodes (spc_2d.rs:425)."""
        nx, ny = self.grid.nx(), self.grid.ny()
        d1r = self.interp_x.get_dd1()
        d1s = self.interp_y.get_dd1()
        dr_dx = 2.0 / (self.xmax - self.xmin)
        ds_dy = 2.0 / (self.ymax - self.ymin)
        A = np.asarray(a).reshape(ny, nx)
        dphi_dx = (A @ d1r.T) * dr_dx
        dphi_dy = (d1s @ A) * ds_dy
        return (self.mkx * dphi_dx).ravel(), (self.mky * dphi_dy).ravel()

    def get_dims_sps(self):
        return self.equations.nu(), self.equations.np()

    def get_dims_lmm(self):
        neq = self.equations.neq()
        return neq, self.equations.np(), neq + self.equations.np()

    def get_equations(self) -> EquationHandler:
        return self.equations

    def for_each_coord(self, callback):
        def wrap(m, r, s):
            x, y = self.map_coord(r, s)
            callback(m, x, y)
        self.grid.for_each_coord(wrap)


class Spc1d:
    """(spc_1d.rs): -kx d2/dx2 + alpha on a CGL grid; solves on
    ``device``."""

    def __init__(self, xmin, xmax, nx: int, ebcs: EssentialBcs1d,
                 nbcs: NaturalBcs1d, kx: float, device="cuda"):
        self.device = russell_tpu_torch.device(device)
        if nx < 2:
            raise ValueError("nx must be >= 2")
        if nx - 1 > 2048:
            raise ValueError("the maximum allowed polynomial degree is 2048")
        if ebcs.periodic_along_x:
            raise ValueError("essential BCs cannot be periodic")
        self.xmin, self.xmax = float(xmin), float(xmax)
        self.grid = Grid1d.new_chebyshev_gauss_lobatto(nx)
        self.ebcs = ebcs
        self.nbcs = nbcs
        self.mkx = -kx
        self.equations = EquationHandler(nx)
        self.equations.recompute(ebcs.get_nodes(self.grid))
        self.interp = InterpLagrange(nx - 1)
        self.interp.calc_dd1_matrix()
        self.interp.calc_dd2_matrix()
        self.genie = Genie.DENSE

    def set_solver_options(self, genie: Genie):
        self.genie = genie

    def map_coord(self, r: float) -> float:
        return (self.xmax + self.xmin + (self.xmax - self.xmin) * r) / 2.0

    def _full_matrix(self, alpha: float) -> np.ndarray:
        nx = self.grid.nx()
        dr_dx = 2.0 / (self.xmax - self.xmin)
        K = self.mkx * dr_dx ** 2 * self.interp.get_dd2() \
            + alpha * np.eye(nx)
        d1 = self.interp.get_dd1()
        if self.nbcs.sides[0]:
            K[0, :] = -self.mkx * d1[0, :] * dr_dx
        if self.nbcs.sides[1]:
            K[nx - 1, :] = self.mkx * d1[nx - 1, :] * dr_dx
        return K

    def solve_sps(self, alpha: float, source) -> np.ndarray:
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        K = self._full_matrix(alpha)
        U = np.array(eq.unknown(), dtype=np.int64)
        P = np.array(eq.prescribed(), dtype=np.int64)
        a_check = np.zeros(eq.np())
        f_bar = np.zeros(eq.nu())
        for m in eq.unknown():
            iu = eq.iu(m)
            x = self.map_coord(self.grid.coord(m))
            if self.grid.is_xmin(m) and self.nbcs.sides[0]:
                f_bar[iu] += self.nbcs.functions[0](x)
            elif self.grid.is_xmax(m) and self.nbcs.sides[1]:
                f_bar[iu] += self.nbcs.functions[1](x)
            else:
                f_bar[iu] = source(x)
        for index in range(2):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    a_check[eq.ip(m)] = self.ebcs.functions[index](
                        self.map_coord(self.grid.coord(m)))
        rhs = f_bar
        if len(P):
            rhs = f_bar - K[np.ix_(U, P)] @ a_check
        a_bar = _solve_dense(K[np.ix_(U, U)], rhs, self.genie,
                             self.device)
        a = np.zeros(eq.neq())
        for m in eq.unknown():
            a[m] = a_bar[eq.iu(m)]
        for m in eq.prescribed():
            a[m] = a_check[eq.ip(m)]
        return a

    def solve_lmm(self, alpha: float, source) -> np.ndarray:
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        neq = eq.neq()
        nlag = eq.np()
        ndim = neq + nlag
        M = np.zeros((ndim, ndim))
        M[:neq, :neq] = self._full_matrix(alpha)
        ff = np.zeros(ndim)
        for m in eq.prescribed():
            ip = eq.ip(m)
            M[neq + ip, m] = 1.0
            M[m, neq + ip] = 1.0
            ff[neq + ip] = self.ebcs.functions[
                0 if self.grid.is_xmin(m) else 1](
                self.map_coord(self.grid.coord(m)))
        for m in range(neq):
            x = self.map_coord(self.grid.coord(m))
            if self.grid.is_xmin(m) and self.nbcs.sides[0]:
                ff[m] += self.nbcs.functions[0](x)
            elif self.grid.is_xmax(m) and self.nbcs.sides[1]:
                ff[m] += self.nbcs.functions[1](x)
            else:
                ff[m] = source(x)
        sol = _solve_dense(M, ff, self.genie, self.device)
        return sol[:neq]

    def calculate_flow_vectors(self, a) -> np.ndarray:
        """q = -k dphi/dx at all nodes (spc_1d.rs:371)."""
        dr_dx = 2.0 / (self.xmax - self.xmin)
        return self.mkx * dr_dx * (self.interp.get_dd1() @ np.asarray(a))

    def get_dims_sps(self):
        return self.equations.nu(), self.equations.np()

    def get_dims_lmm(self):
        neq = self.equations.neq()
        return neq, self.equations.np(), neq + self.equations.np()

    def get_equations(self) -> EquationHandler:
        return self.equations

    def for_each_coord(self, callback):
        for m in range(self.grid.size()):
            callback(m, self.map_coord(self.grid.coord(m)))
