"""Special mathematical functions, in PyTorch (counterpart of
``russell_tpu.math``).

Only the Chebyshev polynomials and point sets are ported so far: the PDE
grids and the Lagrange interpolant need them. The rest of
``russell_tpu.math`` waits for its slice (ROADMAP.md).
"""

from russell_tpu_torch.math.chebyshev import (
    chebyshev_tn, chebyshev_tn_deriv1, chebyshev_tn_deriv2,
    chebyshev_un, chebyshev_un_deriv1, chebyshev_un_deriv2,
    chebyshev_gauss_points, chebyshev_lobatto_points)

__all__ = ["chebyshev_tn", "chebyshev_tn_deriv1", "chebyshev_tn_deriv2",
           "chebyshev_un", "chebyshev_un_deriv1", "chebyshev_un_deriv2",
           "chebyshev_gauss_points", "chebyshev_lobatto_points"]
