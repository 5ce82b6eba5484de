"""ODE/DAE solvers in PyTorch: the Radau5 host stepper.

Counterpart of ``russell_tpu.ode``. The stepper's control logic runs on
the host in f64 (so the statistics counters match Hairer's radau5.f);
the rhs, Jacobian, factorizations and solves run on the tensors' device.
The other methods, dense output and the fused whole-integration loop are
later slices (ROADMAP.md).
"""

from russell_tpu_torch.ode.enums import Method, Information
from russell_tpu_torch.ode.system import System, NoArgs
from russell_tpu_torch.ode.params import (Params, ParamsNewton, ParamsStep,
                                          ParamsStiffness, ParamsBwEuler,
                                          ParamsRadau5, ParamsERK)
from russell_tpu_torch.ode.stats import Stats, Workspace
from russell_tpu_torch.ode.solver import OdeSolver
from russell_tpu_torch.ode import samples

__all__ = [
    "Method", "Information", "System", "NoArgs", "Params", "ParamsNewton",
    "ParamsStep", "ParamsStiffness", "ParamsBwEuler", "ParamsRadau5",
    "ParamsERK", "Stats", "Workspace", "OdeSolver", "samples",
]
