"""ODE/DAE solvers in PyTorch.

Counterpart of ``russell_tpu.ode``: every method of ``Method`` — Radau5,
forward and backward Euler and the 13 explicit Runge-Kutta tableaux —
with ``Output`` (step and dense output, callbacks, JSON files, stiffness
recording), analytic, autodiff (``torch.func.jacfwd``) and numerical
Jacobians, and the reference's samples. The steppers' control logic runs
on the host in f64 (so the statistics counters match Hairer's Fortran
codes); the rhs, Jacobian, factorizations and solves run on the tensors'
device. ``solve(..., fused=True)`` and ``solve_batch`` run the whole
integration of Radau5 or an embedded ERK method on the device instead
(``radau5_fused``, ``erk_fused``): on the card a step attempt captured once
as a CUDA graph whose conditional nodes take the control flow, replayed
until a done flag is set (``_device_loop``).
"""

from russell_tpu_torch.ode.enums import Method, Information
from russell_tpu_torch.ode.system import System, NoArgs
from russell_tpu_torch.ode.params import (Params, ParamsNewton, ParamsStep,
                                          ParamsStiffness, ParamsBwEuler,
                                          ParamsRadau5, ParamsERK)
from russell_tpu_torch.ode.output import Output, OutData, OutCount
from russell_tpu_torch.ode.stats import Stats, Workspace
from russell_tpu_torch.ode.solver import OdeSolver
from russell_tpu_torch.ode.detect_stiffness import (detect_stiffness,
                                                    StiffnessError)
from russell_tpu_torch.ode import samples

__all__ = [
    "Method", "Information", "System", "NoArgs", "Params", "ParamsNewton",
    "ParamsStep", "ParamsStiffness", "ParamsBwEuler", "ParamsRadau5",
    "ParamsERK", "Output", "OutData", "OutCount", "Stats", "Workspace",
    "OdeSolver", "detect_stiffness", "StiffnessError", "samples",
]
