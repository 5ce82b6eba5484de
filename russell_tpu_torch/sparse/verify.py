"""Residual verification of linear-system solutions.

Counterpart of ``russell_tpu.sparse.verify`` (reference contract:
russell_sparse/src/verify_lin_sys.rs:9-14 —
``relative_error = max_abs_diff / (max_abs_a + 1)``). Host numpy: tensors
(on any device) are copied to the host first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["VerifyLinSys"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class VerifyLinSys:
    max_abs_a: float
    max_abs_ax: float
    max_abs_diff: float
    relative_error: float
    time_check_ns: int = 0

    @classmethod
    def from_system(cls, a, x, rhs) -> "VerifyLinSys":
        """Compute ‖A‖max, ‖Ax‖max, ‖Ax-b‖max and the relative error.

        ``a`` may be a CooMatrix / CsrMatrix / CscMatrix / dense array.
        """
        t0 = time.perf_counter_ns()
        x = _host(x)
        rhs = _host(rhs)
        if hasattr(a, "mat_vec_mul"):
            ax = _host(a.mat_vec_mul(x))
            if hasattr(a, "triplets"):
                vals = a.triplets()[2]
            else:
                vals = _host(a.data)
            max_abs_a = float(np.max(np.abs(vals))) if len(vals) else 0.0
        else:
            a = np.asarray(a)
            ax = a @ x
            max_abs_a = float(np.max(np.abs(a)))
        max_abs_ax = float(np.max(np.abs(ax))) if len(ax) else 0.0
        max_abs_diff = float(np.max(np.abs(ax - rhs))) if len(ax) else 0.0
        relative_error = max_abs_diff / (max_abs_a + 1.0)
        return cls(max_abs_a, max_abs_ax, max_abs_diff, relative_error,
                   time_check_ns=time.perf_counter_ns() - t0)
