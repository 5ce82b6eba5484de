"""Linear-solver options (reference: lin_sol_params.rs:5-70).

Only ``LinSolParams`` is ported so far: Radau5 reads it from
``ParamsNewton.lin_sol_params``. ``LinSolver`` and ``StatsLinSol`` are a
later slice (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

from russell_tpu_torch.sparse.enums import Ordering, Scaling

__all__ = ["LinSolParams"]


@dataclass
class LinSolParams:
    """Solver options: the fields of ``russell_tpu.sparse.LinSolParams``
    that the SPLU and GRIDMF paths read (same names and defaults); the
    others come with LinSolver. ``dense_threshold``: Genie.AUTO takes
    GRIDMF for a grid-hinted system only above this n."""

    ordering: Ordering = Ordering.AUTO
    scaling: Scaling = Scaling.AUTO
    pivot_epsilon: float = 1e-14
    refinement_nstep: int = 2
    dense_threshold: int = 1200
