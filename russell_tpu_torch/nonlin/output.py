"""Continuation output recording + callback (reference:
russell_nonlin/src/output.rs — like the ODE Output, per accepted step); a
copy of ``russell_tpu.nonlin.output``: the callback gets the host copy of
u that the step logic holds."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["Output"]


class Output:
    def __init__(self):
        self.step_callback: Optional[Callable] = None
        self.recording = False
        self.step_h: List[float] = []
        self.step_l: List[float] = []
        self._step_u: Dict[int, List[float]] = {}

    def set_step_callback(self, cb: Callable) -> "Output":
        """cb(stats, h, l, u, args) -> bool(stop)."""
        self.step_callback = cb
        return self

    def set_recording(self, selected_u_components) -> "Output":
        self.recording = True
        for m in selected_u_components:
            self._step_u.setdefault(int(m), [])
        return self

    def step_u(self, m: int) -> List[float]:
        return self._step_u.get(m, [])

    def execute(self, work, u, l: float, args) -> bool:
        if self.step_callback is not None:
            if self.step_callback(work.stats, work.h, l, np.asarray(u),
                                  args):
                return True
        if self.recording:
            self.step_h.append(work.h)
            self.step_l.append(l)
            for m, um in self._step_u.items():
                um.append(float(np.asarray(u)[m]))
        return False
