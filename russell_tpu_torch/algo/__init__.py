"""Higher-level algorithms, in PyTorch (counterpart of
``russell_tpu.algo``; reference: russell_lab/src/algo/).

Interpolation (Chebyshev adaptive, barycentric Lagrange with D1/D2
differentiation matrices, B-splines), root finding (Chebyshev companion +
Brent), 1-D minimization (bracketing + Brent + line search), adaptive
quadrature, the dense Newton solver, linear fitting, cubic roots, and the
test-function corpus. The scalar algorithms driven by the user's Python
callbacks (``RootFinder``, ``MinBracketing``, ``MinSolver``,
``LineSearcher``, ``Quadrature``, ``num_jacobian``) and ``misc`` run on
the host, as in the reference; ``NewtonSolver`` and the interpolants'
evaluations follow the device rule of ``core/_place.py``.
"""

from russell_tpu_torch.algo.stats import Stats
from russell_tpu_torch.algo.interp_lagrange import (InterpGrid, InterpParams,
                                                    InterpLagrange)
from russell_tpu_torch.algo.interp_chebyshev import InterpChebyshev
from russell_tpu_torch.algo.root_finder import RootFinder
from russell_tpu_torch.algo.minimize import (Bracket, MinBracketing,
                                             MinSolver, LineSearcher,
                                             line_search)
from russell_tpu_torch.algo.quadrature import Quadrature
from russell_tpu_torch.algo.newton_solver import NewtonSolver, num_jacobian
from russell_tpu_torch.algo.misc import (linear_fitting, solve_cubic, Bspline,
                                         TestFunction, get_test_functions)

__all__ = [
    "Stats", "InterpGrid", "InterpParams", "InterpLagrange",
    "InterpChebyshev", "RootFinder", "Bracket", "MinBracketing", "MinSolver",
    "LineSearcher", "line_search", "Quadrature", "NewtonSolver",
    "num_jacobian", "linear_fitting", "solve_cubic", "Bspline",
    "TestFunction", "get_test_functions",
]
