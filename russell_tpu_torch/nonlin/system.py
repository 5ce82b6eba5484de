"""Nonlinear system G(u, λ) = 0 definition, in PyTorch.

Counterpart of ``russell_tpu.nonlin.system`` (reference contract:
russell_nonlin/src/system.rs): calc_gg computes the residual, calc_jac
computes Gu = dG/du (sparse, frozen structure) and Gλ = dG/dλ. Both are
functions of torch tensors, computed on the device of ``u``;
``torch.func.jacfwd`` supplies the Jacobian when none is given (the
functions must then be functional: no in-place writes on ``u``, no
``.item()``, no numpy).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from russell_tpu_torch.sparse.enums import Sym

__all__ = ["System", "NoArgs"]

NoArgs = type(None)


def _jacfwd_u(gg, l, u, args):
    """dG/du at (l, u), dense (ndim, ndim)."""
    return torch.func.jacfwd(lambda uu: gg(l, uu, args))(u)


class System:
    """G(u, λ) with sparse Gu structure.

    - ``calc_gg(l, u, args) -> G`` (tensor of ndim on u's device)
    - ``calc_jac(l, u, args) -> (ggu_vals, ggl)`` with ggu_vals aligned to
      the frozen (ii, jj) structure and ggl = dG/dλ (tensor of ndim)
    """

    def __init__(self, ndim: int, calc_gg: Callable,
                 calc_jac: Optional[Callable] = None,
                 structure: Optional[Tuple] = None,
                 sym_ggu: Sym = Sym.NO):
        if ndim < 1:
            raise ValueError("ndim must be >= 1")
        self.ndim = ndim
        self.calc_gg = calc_gg
        self.sym_ggu = sym_ggu
        if calc_jac is not None:
            if structure is None:
                raise ValueError("structure (ii, jj) is required with an "
                                 "analytical calc_jac")
            ii, jj = structure
            self.jac_ii = np.asarray(ii, dtype=np.int64)
            self.jac_jj = np.asarray(jj, dtype=np.int64)
            self.calc_jac = calc_jac
        else:
            # autodiff over u and lambda (dense structure)
            ii, jj = np.meshgrid(np.arange(ndim), np.arange(ndim),
                                 indexing="ij")
            self.jac_ii = ii.ravel()
            self.jac_jj = jj.ravel()
            gg = calc_gg

            def ad_jac(l, u, args):
                ggu = _jacfwd_u(gg, l, u, args)
                lt = torch.as_tensor(l, dtype=u.dtype, device=u.device)
                ggl = torch.func.jacfwd(lambda ll: gg(ll, u, args))(lt)
                return ggu.reshape(-1), ggl.reshape(-1)

            self.calc_jac = ad_jac

    @property
    def nnz_ggu(self) -> int:
        return len(self.jac_ii)

    def check_ggu(self, l: float, u, args=None, tol: float = 1e-8):
        """Compare the analytical Gu against autodiff (system.rs:check_ggu),
        on the device of ``u`` (the host for numpy input)."""
        u = torch.as_tensor(u).to(torch.float64)
        vals, _ = self.calc_jac(l, u, args)
        vals = vals.cpu().numpy()
        dense = np.zeros((self.ndim, self.ndim))
        np.add.at(dense, (self.jac_ii, self.jac_jj), vals)
        if self.sym_ggu.triangular():
            off = self.jac_ii != self.jac_jj
            np.add.at(dense, (self.jac_jj[off], self.jac_ii[off]), vals[off])
        ad = _jacfwd_u(self.calc_gg, l, u, args).cpu().numpy()
        err = np.max(np.abs(dense - ad))
        if err > tol:
            raise AssertionError(f"analytical Gu disagrees with autodiff: "
                                 f"max err = {err}")
