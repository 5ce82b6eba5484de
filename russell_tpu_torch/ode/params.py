"""Solver parameters (reference: russell_ode/src/params.rs).

All defaults follow the reference, which in turn follows Hairer's
radau5.f / dopri5.f / dop853.f (line references in params.rs:260-430).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from russell_tpu_torch.ode.enums import Method
from russell_tpu_torch.sparse.enums import Genie
from russell_tpu_torch.sparse.lin_solver import LinSolParams

__all__ = ["Params", "ParamsNewton", "ParamsStep", "ParamsStiffness",
           "ParamsBwEuler", "ParamsRadau5", "ParamsERK"]

EPS = 2.220446049250313e-16  # f64 machine epsilon


@dataclass
class ParamsTol:
    abs: float
    rel: float
    newton: float


@dataclass
class ParamsNewton:
    """params.rs:19 (defaults from radau5.f line 436)."""

    n_iteration_max: int = 7
    use_numerical_jacobian: bool = False
    genie: Genie = Genie.AUTO
    lin_sol_params: Optional[LinSolParams] = None
    write_matrix_after_nstep_and_stop: Optional[int] = None

    def validate(self):
        if self.n_iteration_max < 1:
            raise ValueError("n_iteration_max must be >= 1")


@dataclass
class ParamsStep:
    """params.rs:58 (per-method defaults from the Fortran codes)."""

    m_min: float = 0.2
    m_max: float = 10.0
    m_safety: float = 0.9
    m_first_reject: float = 0.1
    h_ini: float = 1e-4
    n_step_max: int = 100000
    rel_error_prev_min: float = 1e-4

    @staticmethod
    def new(method: Method) -> "ParamsStep":
        if method == Method.RADAU5:
            m = (0.125, 5.0, 0.9, 1e-2)
        elif method == Method.DOPRI5:
            m = (0.2, 10.0, 0.9, 1e-4)
        elif method == Method.DOPRI8:
            m = (0.333, 6.0, 0.9, 1e-4)
        else:
            m = (0.2, 10.0, 0.9, 1e-4)
        return ParamsStep(m_min=m[0], m_max=m[1], m_safety=m[2],
                          rel_error_prev_min=m[3])

    def validate(self):
        if not (0.001 <= self.m_min < 0.5) or self.m_min >= self.m_max:
            raise ValueError("0.001 <= m_min < 0.5 and m_min < m_max required")
        if not (0.01 <= self.m_max <= 20.0):
            raise ValueError("0.01 <= m_max <= 20 required")
        if not (0.1 <= self.m_safety <= 1.0):
            raise ValueError("0.1 <= m_safety <= 1 required")
        if self.m_first_reject < 0.0:
            raise ValueError("m_first_reject >= 0 required")
        if self.h_ini < 1e-8:
            raise ValueError("h_ini >= 1e-8 required")
        if self.n_step_max < 1:
            raise ValueError("n_step_max >= 1 required")
        if self.rel_error_prev_min < 1e-8:
            raise ValueError("rel_error_prev_min >= 1e-8 required")


@dataclass
class ParamsStiffness:
    """params.rs:113 (defaults from dopri5.f:482-492, dop853.f:674-684)."""

    enabled: bool = False
    stop_with_error: bool = True
    save_results: bool = False
    ratified_after_nstep: int = 15
    ignored_after_nstep: int = 6
    skip_first_n_accepted_step: int = 10
    h_times_rho_max: float = -math.inf

    @staticmethod
    def new(method: Method) -> "ParamsStiffness":
        if method == Method.DOPRI5:
            hmax = 3.25
        elif method == Method.DOPRI8:
            hmax = 6.1
        else:
            hmax = -math.inf
        return ParamsStiffness(h_times_rho_max=hmax)


@dataclass
class ParamsBwEuler:
    use_modified_newton: bool = False


@dataclass
class ParamsRadau5:
    """params.rs:155 (defaults from radau5.f lines 487-513)."""

    zero_trial: bool = False
    theta_max: float = 1e-3
    c1h: float = 1.0
    c2h: float = 1.2
    concurrent: bool = True
    use_pred_control: bool = True

    def validate(self):
        if self.theta_max < 1e-7:
            raise ValueError("theta_max >= 1e-7 required")
        if not (0.5 <= self.c1h <= 1.5) or self.c1h >= self.c2h:
            raise ValueError("0.5 <= c1h <= 1.5 and c1h < c2h required")
        if not (1.0 <= self.c2h <= 2.0):
            raise ValueError("1 <= c2h <= 2 required")


@dataclass
class ParamsERK:
    """params.rs:189 (Lund stabilization; dopri5.f:287/381)."""

    lund_beta: float = 0.0
    lund_m: float = 0.0

    @staticmethod
    def new(method: Method) -> "ParamsERK":
        if method == Method.DOPRI5:
            return ParamsERK(0.04, 0.75)
        if method == Method.DOPRI8:
            return ParamsERK(0.0, 0.2)
        return ParamsERK()

    def validate(self):
        if not (0.0 <= self.lund_beta <= 0.1):
            raise ValueError("0 <= lund_beta <= 0.1 required")
        if not (0.0 <= self.lund_m <= 1.0):
            raise ValueError("0 <= lund_m <= 1 required")


def calc_tolerances(radau5: bool, abs_tol: float, rel_tol: float):
    """Tolerance preprocessing (params.rs:486; radau5.f lines 402-410,500)."""
    if abs_tol <= 10.0 * EPS:
        raise ValueError("the absolute tolerance must be > 10 * EPSILON")
    if rel_tol <= 10.0 * EPS:
        raise ValueError("the relative tolerance must be > 10 * EPSILON")
    if radau5:
        beta = 2.0 / 3.0
        quot = abs_tol / rel_tol
        rel_tol = 0.1 * rel_tol ** beta
        abs_tol = rel_tol * quot
    tol_newton = max(10.0 * EPS / rel_tol, min(0.03, math.sqrt(rel_tol)))
    return abs_tol, rel_tol, tol_newton


@dataclass
class Params:
    """Aggregate parameters (params.rs:221)."""

    method: Method
    tol: ParamsTol = None
    newton: ParamsNewton = field(default_factory=ParamsNewton)
    step: ParamsStep = None
    stiffness: ParamsStiffness = None
    bweuler: ParamsBwEuler = field(default_factory=ParamsBwEuler)
    radau5: ParamsRadau5 = field(default_factory=ParamsRadau5)
    erk: ParamsERK = None
    debug: bool = False

    def __post_init__(self):
        if self.tol is None:
            a, r, n = calc_tolerances(self.method == Method.RADAU5, 1e-4, 1e-4)
            self.tol = ParamsTol(a, r, n)
        if self.step is None:
            self.step = ParamsStep.new(self.method)
        if self.stiffness is None:
            self.stiffness = ParamsStiffness.new(self.method)
        if self.erk is None:
            self.erk = ParamsERK.new(self.method)

    def set_tolerances(self, absolute: float, relative: float,
                       newton: Optional[float] = None):
        a, r, n = calc_tolerances(self.method == Method.RADAU5,
                                  absolute, relative)
        self.tol = ParamsTol(a, r, newton if newton is not None else n)

    def validate(self):
        self.newton.validate()
        self.step.validate()
        self.radau5.validate()
        self.erk.validate()
