"""Solver checkpoint/resume.

Counterpart of ``russell_tpu.utils.checkpoint``. The state of an ODE or
continuation run is tiny ((x, y, h) + counters), so a checkpoint is an
atomic .npz snapshot (keys ``x``, ``y``, ``h``, ``meta``, the reference's
layout: either package loads the other's). ``y`` may be a tensor on any
device (copied to the host); ``load`` returns numpy. ``as_step_callback``
plugs into ``russell_tpu_torch.ode.Output.set_step_callback``. Resume =
re-run ``solve`` from the restored (x, y) with h_ini = the restored h —
the semantics the reference documents for its JSON outputs
(russell_ode/src/output.rs:137-171).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from russell_tpu_torch.core._place import host

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, path: str):
        self.path = path

    def save(self, x: float, y, h: float,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Atomic snapshot of the solver state."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        os.close(fd)
        try:
            np.savez(tmp, x=np.float64(x), y=host(y), h=np.float64(h),
                     meta=json.dumps(meta or {}))
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                       self.path)
        finally:
            for p in (tmp, tmp + ".npz"):
                if os.path.exists(p):
                    os.remove(p)

    def load(self) -> Tuple[float, np.ndarray, float, Dict[str, Any]]:
        """(x, y, h, meta) of the last snapshot."""
        with np.load(self.path, allow_pickle=False) as z:
            return (float(z["x"]), np.asarray(z["y"]), float(z["h"]),
                    json.loads(str(z["meta"])))

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def as_step_callback(self, every_n: int = 1):
        """An Output step callback persisting every ``every_n`` accepted
        steps (never requests a stop)."""
        count = {"n": 0}

        def cb(stats, h, x, y, args):
            count["n"] += 1
            if count["n"] % every_n == 0:
                self.save(x, y, h, {"n_accepted": stats.n_accepted})
            return False

        return cb
