"""ODE method registry (reference: russell_ode/src/enums.rs:55-147).

All 14 methods of the reference with their Information table (order,
embedded-estimator order, implicit/embedded/FSAL flags).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

__all__ = ["Method", "Information"]


@dataclass(frozen=True)
class Information:
    """Method properties (enums.rs Information)."""

    order: int
    order_of_estimator: int  # 0 means no error estimator
    implicit: bool
    embedded: bool
    multiple_stages: bool
    first_step_same_as_last: bool


class Method(enum.Enum):
    """The 14 solver methods of the reference (enums.rs:55)."""

    RADAU5 = "radau5"
    BW_EULER = "bweuler"
    FW_EULER = "fweuler"
    RK2 = "rk2"
    RK3 = "rk3"
    HEUN3 = "heun3"
    RK4 = "rk4"
    RK4ALT = "rk4alt"
    MD_EULER = "mdeuler"
    MERSON4 = "merson4"
    ZONNEVELD4 = "zonneveld4"
    FEHLBERG4 = "fehlberg4"
    DOPRI5 = "dopri5"
    VERNER6 = "verner6"
    FEHLBERG7 = "fehlberg7"
    DOPRI8 = "dopri8"

    def information(self) -> Information:
        return _INFO[self]

    @staticmethod
    def erk_methods():
        return [m for m in Method
                if not m.information().implicit and m.information().multiple_stages]


_INFO = {
    Method.RADAU5:     Information(5, 4, True, True, True, False),
    Method.BW_EULER:   Information(1, 0, True, False, False, False),
    Method.FW_EULER:   Information(1, 0, False, False, False, False),
    Method.RK2:        Information(2, 0, False, False, True, False),
    Method.RK3:        Information(3, 0, False, False, True, False),
    Method.HEUN3:      Information(3, 0, False, False, True, False),
    Method.RK4:        Information(4, 0, False, False, True, False),
    Method.RK4ALT:     Information(4, 0, False, False, True, False),
    Method.MD_EULER:   Information(2, 1, False, True, True, False),
    Method.MERSON4:    Information(4, 3, False, True, True, False),
    Method.ZONNEVELD4: Information(4, 3, False, True, True, False),
    Method.FEHLBERG4:  Information(4, 4, False, True, True, False),
    Method.DOPRI5:     Information(5, 4, False, True, True, True),
    Method.VERNER6:    Information(6, 5, False, True, True, False),
    Method.FEHLBERG7:  Information(7, 8, False, True, True, False),
    Method.DOPRI8:     Information(8, 7, False, True, True, False),
}
