"""Spectral collocation on transfinite-mapped (curvilinear) 2-D domains,
on the port's LinSolver.

Counterpart of ``russell_tpu.pde.spc_map``: the operator is assembled on
the host, as in the reference, and solved through ``LinSolver`` (DENSE)
on the solver's ``device`` (the card unless the caller names another).
Reference contract: russell_pde/src/spc_map_2d.rs:161 — the mapped
Laplacian in reference coordinates:

  ∇²φ = gⁱʲ ∂²φ/∂ξⁱ∂ξʲ − Lᵏ ∂φ/∂ξᵏ,   Lᵏ = Γᵏᵢⱼ gⁱʲ

assembled from the CGL differentiation matrices and Metrics at each node
(spc_map_2d.rs:568-640); Neumann rows approximate −k ∂φ/∂n with the
normal projection of the contravariant base vector (spc_map_2d.rs:944).
"""

from __future__ import annotations

import numpy as np

import russell_tpu_torch
from russell_tpu_torch.algo.interp_lagrange import InterpLagrange
from russell_tpu_torch.pde.bcs import EssentialBcs2d, NaturalBcs2d
from russell_tpu_torch.pde.enums import Side
from russell_tpu_torch.pde.equation_handler import EquationHandler
from russell_tpu_torch.pde.grid import Grid2d
from russell_tpu_torch.pde.metrics import Metrics
from russell_tpu_torch.pde.spc import _solve_dense
from russell_tpu_torch.pde.transfinite import Transfinite2d
from russell_tpu_torch.sparse.enums import Genie

__all__ = ["SpcMap2d"]


class SpcMap2d:
    """Spectral collocation on a transfinite map (spc_map_2d.rs:161); solves
    on ``device``."""

    def __init__(self, nr: int, ns: int, trans: Transfinite2d,
                 ebcs: EssentialBcs2d, nbcs: NaturalBcs2d, k: float,
                 device="cuda"):
        self.device = russell_tpu_torch.device(device)
        if nr < 2 or ns < 2:
            raise ValueError("nr and ns must be >= 2")
        if ebcs.periodic_along_x or ebcs.periodic_along_y:
            raise ValueError("essential BCs cannot be periodic")
        self.grid = Grid2d.new_chebyshev_gauss_lobatto(nr, ns)
        self.trans = trans
        self.ebcs = ebcs
        self.nbcs = nbcs
        self.mk = -k
        self.equations = EquationHandler(self.grid.size())
        self.equations.recompute(ebcs.get_nodes(self.grid))
        self.interp_r = InterpLagrange(nr - 1)
        self.interp_s = InterpLagrange(ns - 1)
        self.interp_r.calc_dd1_matrix()
        self.interp_r.calc_dd2_matrix()
        self.interp_s.calc_dd1_matrix()
        self.interp_s.calc_dd2_matrix()
        self.genie = Genie.DENSE
        self.metrics = Metrics(2, homogeneous=False)
        # physical coordinates + per-node metric data
        neq = self.grid.size()
        self._xy = np.zeros((neq, 2))
        self._g11 = np.zeros(neq)
        self._g22 = np.zeros(neq)
        self._g12 = np.zeros(neq)
        self._ll1 = np.zeros(neq)
        self._ll2 = np.zeros(neq)
        self._gctr = np.zeros((neq, 2, 2))
        for m in range(neq):
            r, s = self.grid.coord(m)
            x, dxr, dxs, ddr, dds, ddrs = trans.point_and_derivs(
                r, s, second=True)
            self._xy[m] = x
            self.metrics.calculate_2d(dxr, dxs, ddr, dds, ddrs)
            self._g11[m] = self.metrics.gg_mat[0, 0]
            self._g22[m] = self.metrics.gg_mat[1, 1]
            self._g12[m] = self.metrics.gg_mat[0, 1]
            self._ll1[m] = self.metrics.ell_coefficient_for_laplacian(0)
            self._ll2[m] = self.metrics.ell_coefficient_for_laplacian(1)
            self._gctr[m] = self.metrics.g_ctr

    def set_solver_options(self, genie: Genie):
        self.genie = genie

    def get_map(self) -> Transfinite2d:
        return self.trans

    def map_coord(self, m: int):
        return float(self._xy[m, 0]), float(self._xy[m, 1])

    def _unit_normal(self, m: int, side: Side) -> np.ndarray:
        """(spc_map_2d.rs:944)."""
        g = self._gctr[m]
        if side == Side.XMIN:
            un = -g[0]
        elif side == Side.XMAX:
            un = g[0]
        elif side == Side.YMIN:
            un = -g[1]
        else:
            un = g[1]
        return un / np.linalg.norm(un)

    def _full_matrix(self, alpha: float) -> np.ndarray:
        nr, ns = self.grid.nx(), self.grid.ny()
        neq = nr * ns
        d1r = self.interp_r.get_dd1()
        d1s = self.interp_s.get_dd1()
        d2r = self.interp_r.get_dd2()
        d2s = self.interp_s.get_dd2()
        K = np.zeros((neq, neq))
        for m in range(neq):
            i, j = self.grid.get_ij(m)
            if self.nbcs.enabled_ij(i, j, self.grid):
                row = np.zeros(neq)
                if i == 0 or i == nr - 1:
                    un = self._unit_normal(
                        m, Side.XMIN if i == 0 else Side.XMAX)
                    a = float(un @ self._gctr[m][0])
                    cols = np.arange(nr) + j * nr
                    row[cols] += self.mk * d1r[i, :] * a
                if j == 0 or j == ns - 1:
                    un = self._unit_normal(
                        m, Side.YMIN if j == 0 else Side.YMAX)
                    b = float(un @ self._gctr[m][1])
                    cols = i + np.arange(ns) * nr
                    row[cols] += self.mk * d1s[j, :] * b
                K[m, :] = row
            else:
                cols_r = np.arange(nr) + j * nr
                cols_s = i + np.arange(ns) * nr
                K[m, cols_r] += self.mk * (d2r[i, :] * self._g11[m]
                                           - d1r[i, :] * self._ll1[m])
                K[m, cols_s] += self.mk * (d2s[j, :] * self._g22[m]
                                           - d1s[j, :] * self._ll2[m])
                # cross term: D1r(i,k) D1s(j,l) 2 g12 over all (k,l)
                cross = np.outer(d1s[j, :], d1r[i, :]).ravel()
                K[m, :] += self.mk * 2.0 * self._g12[m] * cross
                K[m, m] += alpha
        return K

    def solve_sps(self, alpha: float, source) -> np.ndarray:
        """SPS solve on the mapped domain (spc_map_2d.rs:378)."""
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        K = self._full_matrix(alpha)
        U = np.array(eq.unknown(), dtype=np.int64)
        P = np.array(eq.prescribed(), dtype=np.int64)
        a_check = np.zeros(eq.np())
        f_bar = np.zeros(eq.nu())
        for m in eq.unknown():
            iu = eq.iu(m)
            x, y = self.map_coord(m)
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
                    x, y = self.map_coord(m)
                    a_check[eq.ip(m)] = self.ebcs.functions[index](x, y)
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
        """(spc_map_2d.rs:432)."""
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
        for m in range(neq):
            x, y = self.map_coord(m)
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
                    x, y = self.map_coord(m)
                    ff[neq + eq.ip(m)] = self.ebcs.functions[index](x, y)
        sol = _solve_dense(M, ff, self.genie, self.device)
        return sol[:neq]

    def calculate_flow_vectors(self, a):
        """(qx, qy) = -k grad(phi) in physical coordinates
        (spc_map_2d.rs:466)."""
        nr, ns = self.grid.nx(), self.grid.ny()
        d1r = self.interp_r.get_dd1()
        d1s = self.interp_s.get_dd1()
        A = np.asarray(a).reshape(ns, nr)
        dphi_dr = (A @ d1r.T).ravel()
        dphi_ds = (d1s @ A).ravel()
        # grad phi = g^1 dphi/dr + g^2 dphi/ds
        gx = self._gctr[:, 0, 0] * dphi_dr + self._gctr[:, 1, 0] * dphi_ds
        gy = self._gctr[:, 0, 1] * dphi_dr + self._gctr[:, 1, 1] * dphi_ds
        return self.mk * gx, self.mk * gy

    def get_dims_sps(self):
        return self.equations.nu(), self.equations.np()

    def get_dims_lmm(self):
        neq = self.equations.neq()
        return neq, self.equations.np(), neq + self.equations.np()

    def get_equations(self) -> EquationHandler:
        return self.equations

    def for_each_coord(self, callback):
        for m in range(self.grid.size()):
            x, y = self.map_coord(m)
            callback(m, x, y)
