"""DOF numbering: unknown/prescribed partition.

Counterpart of ``russell_tpu.pde.equation_handler``, copied (host numpy,
as in the reference).

Reference contract: russell_pde/src/equation_handler.rs:89 — maps global
equation IDs to local unknown (iu) / prescribed (ip) indices; the backbone
of the system-partitioning strategy (SPS).
"""

from __future__ import annotations

import numpy as np

__all__ = ["EquationHandler"]


class EquationHandler:
    def __init__(self, neq: int):
        self._neq = neq
        self._is_prescribed = np.zeros(neq, dtype=bool)
        self.e_to_iu = np.arange(neq)
        self.e_to_ip = np.full(neq, -1)
        self.u_sorted = list(range(neq))
        self.p_sorted: list = []

    def recompute(self, p_list):
        pset = set()
        for p in p_list:
            if p >= self._neq:
                raise IndexError("prescribed equation index is out of bounds")
            pset.add(int(p))
        self.u_sorted = []
        self.p_sorted = []
        self.e_to_iu = np.full(self._neq, -1)
        self.e_to_ip = np.full(self._neq, -1)
        iu = ip = 0
        for e in range(self._neq):
            if e in pset:
                self._is_prescribed[e] = True
                self.e_to_ip[e] = ip
                self.p_sorted.append(e)
                ip += 1
            else:
                self._is_prescribed[e] = False
                self.e_to_iu[e] = iu
                self.u_sorted.append(e)
                iu += 1

    def neq(self) -> int:
        return self._neq

    def nu(self) -> int:
        return len(self.u_sorted)

    def np(self) -> int:
        return len(self.p_sorted)

    def is_unknown(self, e: int) -> bool:
        return not self._is_prescribed[e]

    def is_prescribed(self, e: int) -> bool:
        return bool(self._is_prescribed[e])

    def iu(self, e: int) -> int:
        v = self.e_to_iu[e]
        if v < 0:
            raise ValueError("global equation ID does not correspond to an "
                             "unknown equation")
        return int(v)

    def ip(self, e: int) -> int:
        v = self.e_to_ip[e]
        if v < 0:
            raise ValueError("global equation ID does not correspond to a "
                             "prescribed equation")
        return int(v)

    def unknown(self):
        return self.u_sorted

    def prescribed(self):
        return self.p_sorted
