"""Numerical continuation G(u, λ) = 0, in PyTorch.

Counterpart of ``russell_tpu.nonlin``, which re-designs
``russell_nonlin`` (reference: russell_nonlin/src/lib.rs:24-104):
natural-parameter and pseudo-arclength continuation with Euler
predictors, Newton correctors through the port's ``factor`` (bordering
algorithm), PID-VCC tangent-based stepsize adaptation, stop criteria,
logger, and output recording. ``Solver(config, system, device)`` computes
G, its Jacobian, the factorizations and the solves on ``device`` (the
card unless the caller names another); the step logic runs on the host.
"""

from russell_tpu_torch.nonlin.config import (CONFIG_H_MIN, Config,
                                             DeltaLambda, IniDir, Method,
                                             Status, Stop)
from russell_tpu_torch.nonlin.system import System, NoArgs
from russell_tpu_torch.nonlin.stats import Stats, Workspace, IterationError
from russell_tpu_torch.nonlin.solver import Solver
from russell_tpu_torch.nonlin.solvers import SolverArclength, SolverNatural
from russell_tpu_torch.nonlin.logger import Logger
from russell_tpu_torch.nonlin.output import Output
from russell_tpu_torch.nonlin import samples

__all__ = [
    "CONFIG_H_MIN", "Config", "DeltaLambda", "IniDir", "Method", "Status",
    "Stop", "System", "NoArgs", "Stats", "Workspace", "IterationError",
    "Solver", "SolverArclength", "SolverNatural", "Logger", "Output",
    "samples",
]
