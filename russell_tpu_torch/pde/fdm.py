"""Finite-difference solvers for α·φ − ∇·(k∇φ) = s on 1-D/2-D grids,
on the port's LinSolver.

Counterpart of ``russell_tpu.pde.fdm``. Reference contracts:
russell_pde/src/fdm_1d.rs and fdm_2d.rs:279 —
3/5-point molecules with ghost-mirroring (Neumann) or periodic wrap,
boundary-row halving, SPS (system partitioning: K̄ ā = f̄ − Ǩ ǎ) and LMM
(Lagrange-multiplier saddle system) solution strategies, natural-BC flux
terms on the rhs.

Assembly is vectorized numpy into COO on the host, and the right-hand
sides call the user's per-point callbacks in host loops, as in the
reference; the factorize and solve run through ``LinSolver`` on the
solver's ``device`` (the card unless the caller names another), and a
solve returns a host numpy array. ``Fdm2d.solve_sps`` passes the interior
grid hint, so AUTO takes GRIDMF above ``dense_threshold`` (its pivot-block
inverses are the ``gj_inv`` CUDA kernel on the card).
"""

from __future__ import annotations

import numpy as np

import russell_tpu_torch
from russell_tpu_torch.pde.bcs import (EssentialBcs1d, EssentialBcs2d,
                                       NaturalBcs1d, NaturalBcs2d)
from russell_tpu_torch.pde.enums import Side
from russell_tpu_torch.pde.equation_handler import EquationHandler
from russell_tpu_torch.pde.grid import Grid1d, Grid2d
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import Genie, Sym
from russell_tpu_torch.sparse.lin_solver import LinSolParams, LinSolver

__all__ = ["Fdm1d", "Fdm2d"]


def _solve_coo(coo: CooMatrix, rhs: np.ndarray, genie: Genie, device,
               grid_hint=None) -> np.ndarray:
    """x of ``coo`` x = ``rhs`` through a LinSolver on ``device``, as a host
    array."""
    solver = LinSolver(genie, device)
    params = None
    if grid_hint is not None:
        params = LinSolParams()
        params.grid = grid_hint
    solver.factorize(coo, params)
    return solver.solve(rhs).cpu().numpy()


class Fdm2d:
    """5-point FDM on a uniform 2-D grid (fdm_2d.rs:279); solves on
    ``device``."""

    def __init__(self, grid: Grid2d, ebcs: EssentialBcs2d,
                 nbcs: NaturalBcs2d, kx: float, ky: float, device="cuda"):
        self.device = russell_tpu_torch.device(device)
        d = grid.get_dx_dy()
        if d is None:
            raise ValueError("grid must have uniform spacing")
        self.dx, self.dy = d
        self.grid = grid
        self.ebcs = ebcs
        self.nbcs = nbcs
        neq = grid.size()
        self.equations = EquationHandler(neq)
        self.equations.recompute(ebcs.get_nodes(grid))
        dx2, dy2 = self.dx ** 2, self.dy ** 2
        self.molecule = np.array([2.0 * (kx / dx2 + ky / dy2), -kx / dx2,
                                  -kx / dx2, -ky / dy2, -ky / dy2])
        self.genie = Genie.AUTO
        # neighbor table nn[b, m] (fdm_2d.rs:959-972)
        nx, ny = grid.nx(), grid.ny()
        m = np.arange(neq)
        i = m % nx
        j = m // nx
        nn = np.zeros((5, neq), dtype=np.int64)
        nn[0] = m
        if ebcs.periodic_along_x:
            nn[1] = np.where(i != 0, m - 1, m + (nx - 1))
            nn[2] = np.where(i != nx - 1, m + 1, m - (nx - 1))
        else:
            nn[1] = np.where(i != 0, m - 1, m + 1)
            nn[2] = np.where(i != nx - 1, m + 1, m - 1)
        if ebcs.periodic_along_y:
            nn[3] = np.where(j != 0, m - nx, m + (ny - 1) * nx)
            nn[4] = np.where(j != ny - 1, m + nx, m - (ny - 1) * nx)
        else:
            nn[3] = np.where(j != 0, m - nx, m + nx)
            nn[4] = np.where(j != ny - 1, m + nx, m - nx)
        self.nn = nn
        self._i, self._j = i, j

    def set_solver_options(self, genie: Genie, symmetric: bool = False):
        self.genie = genie

    def _sps_grid_hint(self):
        """GRIDMF structure hint for the SPS K-bar: when the unknown set
        is exactly the interior rectangle (all-Dirichlet boundary, no
        periodicity), the unknowns form an (ny-2, nx-2) row-major grid
        with a reach-1 stencil — the multifrontal fast path."""
        if self.ebcs.periodic_along_x or self.ebcs.periodic_along_y:
            return None
        nx, ny = self.grid.nx(), self.grid.ny()
        if nx < 4 or ny < 4:
            return None
        interior = (self._i > 0) & (self._i < nx - 1) & \
                   (self._j > 0) & (self._j < ny - 1)
        unknown = self.equations.e_to_iu >= 0
        if not np.array_equal(interior, unknown):
            return None
        return (ny - 2, nx - 2, 1)

    # -- shared row values ----------------------------------------------------

    def _row_scale(self) -> np.ndarray:
        """Boundary-row halving factors (fdm_2d.rs:622-630)."""
        nx, ny = self.grid.nx(), self.grid.ny()
        s = np.ones(self.grid.size())
        if not self.ebcs.periodic_along_x:
            s[(self._i == 0) | (self._i == nx - 1)] /= 2.0
        if not self.ebcs.periodic_along_y:
            s[(self._j == 0) | (self._j == ny - 1)] /= 2.0
        return s

    def _all_values(self, alpha: float) -> np.ndarray:
        """val[b, m] entries of the K matrix before partitioning."""
        vals = np.tile(self.molecule[:, None], (1, self.grid.size()))
        vals[0] += alpha
        return vals * self._row_scale()[None, :]

    # -- SPS ------------------------------------------------------------------

    def get_matrices_sps(self, alpha: float, extra_nnz: int = 0,
                         sym_kk_bar: Sym = Sym.NO):
        """(kk_bar, kk_check) of the partitioned system (fdm_2d.rs:603)."""
        eq = self.equations
        nu, npres = eq.nu(), eq.np()
        vals = self._all_values(alpha)
        rows = np.repeat(np.arange(self.grid.size())[None, :], 5, axis=0)
        m_flat = rows.ravel()
        n_flat = self.nn.ravel()
        v_flat = vals.ravel()
        keep = eq.e_to_iu[m_flat] >= 0
        m_u, n_u, v_u = m_flat[keep], n_flat[keep], v_flat[keep]
        col_unknown = eq.e_to_iu[n_u] >= 0
        # K-bar: unknown x unknown
        mb = m_u[col_unknown]
        nb = n_u[col_unknown]
        vb = v_u[col_unknown]
        if sym_kk_bar == Sym.YES_LOWER:
            sel = mb >= nb
            mb, nb, vb = mb[sel], nb[sel], vb[sel]
        elif sym_kk_bar == Sym.YES_UPPER:
            sel = mb <= nb
            mb, nb, vb = mb[sel], nb[sel], vb[sel]
        kk_bar = CooMatrix.from_arrays(nu, nu, eq.e_to_iu[mb], eq.e_to_iu[nb],
                                       vb, sym_kk_bar)
        if npres == 0:
            return kk_bar, None
        mc = m_u[~col_unknown]
        nc = n_u[~col_unknown]
        vc = v_u[~col_unknown]
        kk_check = CooMatrix.from_arrays(nu, npres, eq.e_to_iu[mc],
                                         eq.e_to_ip[nc], vc)
        return kk_bar, kk_check

    def get_vectors_sps(self, source):
        """(a_bar, a_check, f_bar) (fdm_2d.rs:750)."""
        eq = self.equations
        a_bar = np.zeros(eq.nu())
        a_check = np.zeros(eq.np())
        f_bar = np.zeros(eq.nu())
        for m in eq.unknown():
            iu = eq.iu(m)
            x, y = self.grid.coord(m)
            den = 1.0
            cf = 0.5 if self.grid.is_corner(m) else 1.0
            if not self.ebcs.periodic_along_x:
                if self.grid.is_xmin(m):
                    f_bar[iu] += -cf * self.nbcs.functions[0](x, y) / self.dx
                    den *= 2.0
                elif self.grid.is_xmax(m):
                    f_bar[iu] += -cf * self.nbcs.functions[1](x, y) / self.dx
                    den *= 2.0
            if not self.ebcs.periodic_along_y:
                if self.grid.is_ymin(m):
                    f_bar[iu] += -cf * self.nbcs.functions[2](x, y) / self.dy
                    den *= 2.0
                elif self.grid.is_ymax(m):
                    f_bar[iu] += -cf * self.nbcs.functions[3](x, y) / self.dy
                    den *= 2.0
            f_bar[iu] += source(x, y) / den
        for index in range(4):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    x, y = self.grid.coord(m)
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
        """SPS solve: K̄ ā = f̄ − Ǩ ǎ (fdm_2d.rs:439)."""
        self.ebcs.validate(self.nbcs)
        kk_bar, kk_check = self.get_matrices_sps(alpha)
        _, a_check, f_bar = self.get_vectors_sps(source)
        rhs = f_bar
        if kk_check is not None:
            rhs = f_bar - kk_check.mat_vec_mul(a_check)
        a_bar = _solve_coo(kk_bar, rhs, self.genie, self.device,
                           self._sps_grid_hint())
        return self.get_joined_vector_sps(a_bar, a_check)

    # -- LMM ------------------------------------------------------------------

    def get_dims_sps(self):
        return self.equations.nu(), self.equations.np()

    def get_dims_lmm(self):
        neq = self.equations.neq()
        nlag = self.equations.np()
        return neq, nlag, neq + nlag

    def get_matrices_lmm(self, alpha: float, extra_nnz: int = 0,
                         get_constraints_mat: bool = False,
                         sym_mm: Sym = Sym.NO):
        """Augmented saddle matrix [[K, C^T], [C, 0]] (fdm_2d.rs:672)."""
        eq = self.equations
        neq, nlag, ndim = self.get_dims_lmm()
        vals = self._all_values(alpha)
        rows = np.repeat(np.arange(neq)[None, :], 5, axis=0).ravel()
        cols = self.nn.ravel()
        v = vals.ravel()
        if sym_mm == Sym.YES_LOWER:
            sel = rows >= cols
            rows, cols, v = rows[sel], cols[sel], v[sel]
        elif sym_mm == Sym.YES_UPPER:
            sel = rows <= cols
            rows, cols, v = rows[sel], cols[sel], v[sel]
        pr = np.array(eq.prescribed(), dtype=np.int64)
        ips = eq.e_to_ip[pr] + neq
        if sym_mm == Sym.YES_LOWER:
            rr = np.concatenate([rows, ips])
            cc = np.concatenate([cols, pr])
            vv = np.concatenate([v, np.ones(nlag)])
        elif sym_mm == Sym.YES_UPPER:
            rr = np.concatenate([rows, pr])
            cc = np.concatenate([cols, ips])
            vv = np.concatenate([v, np.ones(nlag)])
        else:
            rr = np.concatenate([rows, ips, pr])
            cc = np.concatenate([cols, pr, ips])
            vv = np.concatenate([v, np.ones(nlag), np.ones(nlag)])
        mm = CooMatrix.from_arrays(ndim, ndim, rr, cc, vv, sym_mm)
        if get_constraints_mat and nlag > 0:
            ccm = CooMatrix.from_arrays(nlag, neq, eq.e_to_ip[pr], pr,
                                        np.ones(nlag))
            return mm, ccm
        return mm, None

    def get_vectors_lmm(self, source):
        """(aa, ff) of the augmented system (fdm_2d.rs:841)."""
        eq = self.equations
        neq, nlag, ndim = self.get_dims_lmm()
        aa = np.zeros(ndim)
        ff = np.zeros(ndim)

        def body(m, x, y):
            den = 1.0
            cf = 0.5 if self.grid.is_corner(m) else 1.0
            if not self.ebcs.periodic_along_x:
                if self.grid.is_xmin(m):
                    ff[m] += -cf * self.nbcs.functions[0](x, y) / self.dx
                    den *= 2.0
                if self.grid.is_xmax(m):
                    ff[m] += -cf * self.nbcs.functions[1](x, y) / self.dx
                    den *= 2.0
            if not self.ebcs.periodic_along_y:
                if self.grid.is_ymin(m):
                    ff[m] += -cf * self.nbcs.functions[2](x, y) / self.dy
                    den *= 2.0
                if self.grid.is_ymax(m):
                    ff[m] += -cf * self.nbcs.functions[3](x, y) / self.dy
                    den *= 2.0
            ff[m] += source(x, y) / den

        self.grid.for_each_coord(body)
        for index in range(4):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    x, y = self.grid.coord(m)
                    ff[neq + eq.ip(m)] = self.ebcs.functions[index](x, y)
        return aa, ff

    def solve_lmm(self, alpha: float, source) -> np.ndarray:
        """LMM solve of the augmented saddle system (fdm_2d.rs:497)."""
        self.ebcs.validate(self.nbcs)
        mm, _ = self.get_matrices_lmm(alpha)
        _, ff = self.get_vectors_lmm(source)
        sol = _solve_coo(mm, ff, self.genie, self.device)
        return sol[: self.equations.neq()]

    # -- iteration helpers ----------------------------------------------------

    def get_grid(self) -> Grid2d:
        return self.grid

    def get_equations(self) -> EquationHandler:
        return self.equations

    def loop_over_molecule(self, m: int, callback):
        for b in range(5):
            callback(int(self.nn[b, m]), float(self.molecule[b]))

    def for_each_coord(self, callback):
        self.grid.for_each_coord(callback)


class Fdm1d:
    """3-point FDM on a uniform 1-D grid (fdm_1d.rs:275); solves on
    ``device``."""

    def __init__(self, grid: Grid1d, ebcs: EssentialBcs1d,
                 nbcs: NaturalBcs1d, kx: float, device="cuda"):
        self.device = russell_tpu_torch.device(device)
        dx = grid.get_dx()
        if dx is None:
            raise ValueError("grid must have uniform spacing")
        self.dx = dx
        self.grid = grid
        self.ebcs = ebcs
        self.nbcs = nbcs
        neq = grid.size()
        self.equations = EquationHandler(neq)
        self.equations.recompute(ebcs.get_nodes(grid))
        dx2 = dx * dx
        self.molecule = np.array([2.0 * kx / dx2, -kx / dx2, -kx / dx2])
        self.genie = Genie.AUTO
        n = neq
        m = np.arange(n)
        nn = np.zeros((3, n), dtype=np.int64)
        nn[0] = m
        if ebcs.periodic_along_x:
            nn[1] = np.where(m != 0, m - 1, n - 1)
            nn[2] = np.where(m != n - 1, m + 1, 0)
        else:
            nn[1] = np.where(m != 0, m - 1, m + 1)
            nn[2] = np.where(m != n - 1, m + 1, m - 1)
        self.nn = nn

    def set_solver_options(self, genie: Genie, symmetric: bool = False):
        self.genie = genie

    def _all_values(self, alpha: float) -> np.ndarray:
        n = self.grid.size()
        vals = np.tile(self.molecule[:, None], (1, n))
        vals[0] += alpha
        if not self.ebcs.periodic_along_x:
            vals[:, 0] /= 2.0
            vals[:, -1] /= 2.0
        return vals

    def get_matrices_sps(self, alpha: float, extra_nnz: int = 0,
                         sym_kk_bar: Sym = Sym.NO):
        eq = self.equations
        nu, npres = eq.nu(), eq.np()
        vals = self._all_values(alpha)
        rows = np.repeat(np.arange(self.grid.size())[None, :], 3,
                         axis=0).ravel()
        cols = self.nn.ravel()
        v = vals.ravel()
        keep = eq.e_to_iu[rows] >= 0
        m_u, n_u, v_u = rows[keep], cols[keep], v[keep]
        colu = eq.e_to_iu[n_u] >= 0
        kk_bar = CooMatrix.from_arrays(nu, nu, eq.e_to_iu[m_u[colu]],
                                       eq.e_to_iu[n_u[colu]], v_u[colu])
        if npres == 0:
            return kk_bar, None
        kk_check = CooMatrix.from_arrays(nu, npres, eq.e_to_iu[m_u[~colu]],
                                         eq.e_to_ip[n_u[~colu]], v_u[~colu])
        return kk_bar, kk_check

    def get_vectors_sps(self, source):
        eq = self.equations
        a_bar = np.zeros(eq.nu())
        a_check = np.zeros(eq.np())
        f_bar = np.zeros(eq.nu())
        for m in eq.unknown():
            iu = eq.iu(m)
            x = self.grid.coord(m)
            den = 1.0
            if not self.ebcs.periodic_along_x:
                if self.grid.is_xmin(m):
                    f_bar[iu] += -self.nbcs.functions[0](x) / self.dx
                    den *= 2.0
                elif self.grid.is_xmax(m):
                    f_bar[iu] += -self.nbcs.functions[1](x) / self.dx
                    den *= 2.0
            f_bar[iu] += source(x) / den
        for index in range(2):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    a_check[eq.ip(m)] = self.ebcs.functions[index](
                        self.grid.coord(m))
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
        kk_bar, kk_check = self.get_matrices_sps(alpha)
        _, a_check, f_bar = self.get_vectors_sps(source)
        rhs = f_bar
        if kk_check is not None:
            rhs = f_bar - kk_check.mat_vec_mul(a_check)
        a_bar = _solve_coo(kk_bar, rhs, self.genie, self.device)
        return self.get_joined_vector_sps(a_bar, a_check)

    def solve_lmm(self, alpha: float, source) -> np.ndarray:
        self.ebcs.validate(self.nbcs)
        eq = self.equations
        neq = eq.neq()
        nlag = eq.np()
        ndim = neq + nlag
        vals = self._all_values(alpha)
        rows = np.repeat(np.arange(neq)[None, :], 3, axis=0).ravel()
        cols = self.nn.ravel()
        v = vals.ravel()
        pr = np.array(eq.prescribed(), dtype=np.int64)
        ips = eq.e_to_ip[pr] + neq
        rr = np.concatenate([rows, ips, pr])
        cc = np.concatenate([cols, pr, ips])
        vv = np.concatenate([v, np.ones(nlag), np.ones(nlag)])
        mm = CooMatrix.from_arrays(ndim, ndim, rr, cc, vv)
        ff = np.zeros(ndim)
        for m in range(neq):
            x = self.grid.coord(m)
            den = 1.0
            if not self.ebcs.periodic_along_x:
                if self.grid.is_xmin(m):
                    ff[m] += -self.nbcs.functions[0](x) / self.dx
                    den *= 2.0
                if self.grid.is_xmax(m):
                    ff[m] += -self.nbcs.functions[1](x) / self.dx
                    den *= 2.0
            ff[m] += source(x) / den
        for index in range(2):
            if self.ebcs.sides[index]:
                for m in self.grid.get_nodes_on_side(Side.from_index(index)):
                    ff[neq + eq.ip(m)] = self.ebcs.functions[index](
                        self.grid.coord(m))
        sol = _solve_coo(mm, ff, self.genie, self.device)
        return sol[:neq]

    def get_dims_sps(self):
        return self.equations.nu(), self.equations.np()

    def get_dims_lmm(self):
        neq = self.equations.neq()
        return neq, self.equations.np(), neq + self.equations.np()

    def get_grid(self) -> Grid1d:
        return self.grid

    def get_equations(self) -> EquationHandler:
        return self.equations

    def loop_over_molecule(self, m: int, callback):
        for b in range(3):
            callback(int(self.nn[b, m]), float(self.molecule[b]))

    def for_each_coord(self, callback):
        self.grid.for_each_coord(callback)
