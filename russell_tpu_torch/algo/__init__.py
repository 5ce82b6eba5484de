"""Higher-level algorithms, in PyTorch (counterpart of
``russell_tpu.algo``).

Ported so far: what the PDE and continuation modules use — the
barycentric Lagrange interpolant with its D1/D2 differentiation matrices
(``interp_lagrange``) and ``misc`` whole (linear fitting, cubic roots,
B-splines, the test-function corpus). The rest of ``russell_tpu.algo``
waits for its slice (ROADMAP.md).
"""

from russell_tpu_torch.algo.interp_lagrange import (InterpGrid, InterpParams,
                                                    InterpLagrange)
from russell_tpu_torch.algo.misc import (linear_fitting, solve_cubic, Bspline,
                                         TestFunction, get_test_functions)

__all__ = ["InterpGrid", "InterpParams", "InterpLagrange", "linear_fitting",
           "solve_cubic", "Bspline", "TestFunction", "get_test_functions"]
