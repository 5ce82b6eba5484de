"""Continuation enums + configuration.

Counterpart of ``russell_tpu.nonlin.config``, copied; ``genie`` is this
package's ``Genie``.

Reference contracts: russell_nonlin/src/enums.rs (Method:214, Stop:88,
IniDir:46, Status:306) and config.rs:13 (defaults at config.rs:225-270).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from russell_tpu_torch.sparse.enums import Genie

__all__ = ["Method", "IniDir", "Stop", "Status", "Config", "DeltaLambda",
           "CONFIG_H_MIN"]

CONFIG_H_MIN = 1e-10


class Method(enum.Enum):
    NATURAL = "natural"
    ARCLENGTH = "arclength"


class IniDir(enum.Enum):
    POS = 1
    NEG = -1


class Status(enum.Enum):
    SUCCESS = "success"
    NAN_OR_INF_RESIDUAL = "nan_or_inf_residual"
    NAN_OR_INF_DELTA = "nan_or_inf_delta"
    BORDERING_SMALL_DENOMINATOR = "bordering_small_denominator"
    LARGE_DELTA = "large_delta"
    REACHED_MAX_ITERATIONS = "reached_max_iterations"
    CONTINUED_RESIDUAL_DIVERGENCE = "continued_residual_divergence"
    CONTINUED_DELTA_DIVERGENCE = "continued_delta_divergence"
    REJECTION = "rejection"
    UNMET_STOP_CRITERION = "unmet_stop_criterion"
    SMALL_STEPSIZE = "small_stepsize"
    CONTINUED_FAILURE = "continued_failure"
    CONTINUED_REJECTION = "continued_rejection"

    def success(self) -> bool:
        return self == Status.SUCCESS

    def failure(self) -> bool:
        return self != Status.SUCCESS

    def try_again(self) -> bool:
        """Failures that allow retrying with a smaller step
        (enums.rs:379-400)."""
        return self in (Status.BORDERING_SMALL_DENOMINATOR,
                        Status.LARGE_DELTA, Status.REACHED_MAX_ITERATIONS,
                        Status.CONTINUED_RESIDUAL_DIVERGENCE,
                        Status.CONTINUED_DELTA_DIVERGENCE, Status.REJECTION,
                        Status.UNMET_STOP_CRITERION,
                        Status.NAN_OR_INF_RESIDUAL, Status.NAN_OR_INF_DELTA)


class Stop:
    """Stop criterion (enums.rs:88)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.kw = kw

    @staticmethod
    def min_comp_u(index: int, min_value: float) -> "Stop":
        return Stop("min_comp_u", index=index, value=min_value)

    @staticmethod
    def max_comp_u(index: int, max_value: float) -> "Stop":
        return Stop("max_comp_u", index=index, value=max_value)

    @staticmethod
    def max_norm_u(max_value: float, begin: int = 0,
                   end: Optional[int] = None) -> "Stop":
        return Stop("max_norm_u", value=max_value, begin=begin, end=end)

    @staticmethod
    def min_lambda(value: float) -> "Stop":
        return Stop("min_lambda", value=value)

    @staticmethod
    def max_lambda(value: float) -> "Stop":
        return Stop("max_lambda", value=value)

    @staticmethod
    def steps(n: int) -> "Stop":
        return Stop("steps", value=n)

    def lambda_target(self) -> Optional[Tuple[float, bool]]:
        """(l1, is_min) when the criterion targets lambda."""
        if self.kind == "min_lambda":
            return self.kw["value"], True
        if self.kind == "max_lambda":
            return self.kw["value"], False
        return None

    def u_comp(self) -> Optional[Tuple[int, float, bool]]:
        if self.kind == "min_comp_u":
            return self.kw["index"], self.kw["value"], True
        if self.kind == "max_comp_u":
            return self.kw["index"], self.kw["value"], False
        return None

    def validate(self, u, l: float):
        uc = self.u_comp()
        if uc is not None:
            i, v, is_min = uc
            if i >= len(u):
                raise ValueError("stop index out of range")
        if self.kind == "steps" and self.kw["value"] < 1:
            raise ValueError("number of steps must be >= 1")

    def now(self, i_step: int, u, l: float) -> bool:
        k = self.kind
        if k == "min_comp_u":
            return float(u[self.kw["index"]]) <= self.kw["value"]
        if k == "max_comp_u":
            return float(u[self.kw["index"]]) >= self.kw["value"]
        if k == "max_norm_u":
            end = self.kw["end"] or len(u)
            return float(np.linalg.norm(
                np.asarray(u)[self.kw["begin"]:end])) >= self.kw["value"]
        if k == "min_lambda":
            return l <= self.kw["value"] + CONFIG_H_MIN
        if k == "max_lambda":
            return l >= self.kw["value"] - CONFIG_H_MIN
        if k == "steps":
            return i_step + 1 >= self.kw["value"]
        return False


class DeltaLambda:
    """Delta-lambda strategy (delta_lambda.rs:15)."""

    def __init__(self, auto: bool, ddl_ini: float, lst: List[float]):
        self.auto_flag = auto
        self.ddl_ini = ddl_ini
        self.list = lst

    @staticmethod
    def auto(ddl_ini: float) -> "DeltaLambda":
        return DeltaLambda(True, ddl_ini, [])

    @staticmethod
    def constant(ddl: float) -> "DeltaLambda":
        return DeltaLambda(False, ddl, [])

    @staticmethod
    def from_list(lst) -> "DeltaLambda":
        assert len(lst) > 0
        return DeltaLambda(False, lst[0], list(lst))

    def is_auto(self) -> bool:
        return self.auto_flag

    def ini(self, stop: Stop, l0: float) -> float:
        ddl = self.ddl_ini
        t = stop.lambda_target()
        if t is not None:
            l1, _ = t
            ddl = min(ddl, abs(l0 - l1))
        if ddl <= CONFIG_H_MIN:
            raise ValueError("requirement: ddl_ini > 1e-10")
        return ddl


@dataclass
class Config:
    """(config.rs:13; defaults config.rs:225-270)."""

    method: Method = Method.NATURAL
    verbose: bool = False
    verbose_iterations: bool = False
    verbose_header_footer: bool = False
    m_failure: float = 0.5
    n_step_max: int = 100000
    n_cont_failure_max: int = 5
    n_cont_rejection_max: int = 5
    genie: Genie = Genie.AUTO
    lin_sol_config = None
    write_matrix_after_nstep_and_stop = None  # dump Gu + stop (debug)
    tol_abs_residual: float = 1e-10
    tol_abs_delta: float = 1e-10
    tol_rel_delta: float = 1e-7
    delta_max_allowed: float = 1e8
    disable_rel_delta_analysis: bool = False
    n_iteration_max: int = 20
    n_cont_residual_divergence_max: int = 3
    n_cont_delta_divergence_max: int = 5
    euler_predictor: bool = True
    bordering: bool = True
    # tangent-based stepsize control (PID-VCC by default)
    nr_control_enabled: bool = False
    nr_control_n_opt: int = 3
    nr_control_beta: float = 0.5
    tg_control_enabled: bool = True
    tg_control_pid_vcc: bool = True
    tg_control_tol: float = 0.5
    tg_control_rdiff_min: float = 1e-6
    tg_control_rho_for_tiny_rdiff: float = 1.2
    tg_control_rdiff_type: str = "ave"  # or "max"

    def validate(self):
        if self.tol_abs_residual < 1e-12:
            raise ValueError("requirement: tol_abs_residual >= 1e-12")
        if self.n_iteration_max < 1:
            raise ValueError("n_iteration_max must be >= 1")
