"""Step + dense output handling, for the PyTorch port (reference:
russell_ode/src/output.rs:48).

Counterpart of ``russell_tpu.ode.output``. The solver's state stays on its
device; an Output copies to the host only what it consumes: the whole y
for a callback or a JSON file, the selected components for recording,
one scalar for the global error. A dense station is evaluated on the
device (the stepper's ``dense_output``) and copied when it is consumed.
With no Output attached the solver copies nothing.

Behavioral contract mirrored:
- step recording (h, x, selected y components, global error vs y(x))
- dense output stations from ``h_out`` or an explicit interior x list
  (output.rs:269,285), interpolated from the stepper's collocation/dense
  polynomial between accepted steps
- callbacks may return True to stop the solver gracefully (output.rs:316)
- JSON persistence: OutData {h, x, y} files plus an OutCount {n} file
  (output.rs:137-171)
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Output", "OutData", "OutCount"]

EPS = 2.220446049250313e-16
EPS_X1_H_OUT = 1e-13


def _host(y) -> np.ndarray:
    """y (a tensor on any device, or anything numpy reads) as an f64 numpy
    array on the host."""
    if isinstance(y, torch.Tensor):
        return y.detach().to("cpu", torch.float64).numpy()
    return np.asarray(y, dtype=np.float64)


def _selected(y: torch.Tensor, idx) -> list:
    """The components ``idx`` of y as host floats: one copy of just those
    components."""
    if not idx:
        return []
    return y.index_select(0, torch.as_tensor(idx, device=y.device)).tolist()


class OutData:
    """One output record {h, x, y} (output.rs:18)."""

    def __init__(self, h: float, x: float, y):
        self.h = float(h)
        self.x = float(x)
        self.y = _host(y)

    def write_json(self, full_path: str):
        d = os.path.dirname(full_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(full_path, "w") as f:
            json.dump({"h": self.h, "x": self.x, "y": self.y.tolist()}, f)

    @staticmethod
    def read_json(full_path: str) -> "OutData":
        with open(full_path) as f:
            d = json.load(f)
        return OutData(d["h"], d["x"], d["y"])


class OutCount:
    """File counter record (output.rs:38)."""

    def __init__(self, n: int = 0):
        self.n = int(n)

    def write_json(self, full_path: str):
        d = os.path.dirname(full_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(full_path, "w") as f:
            json.dump({"n": self.n}, f)

    @staticmethod
    def read_json(full_path: str) -> "OutCount":
        with open(full_path) as f:
            return OutCount(json.load(f)["n"])


class Output:
    """Records/streams results at accepted steps and dense stations."""

    def __init__(self):
        self.initialized = False
        self.x0 = 0.0
        self.x1 = 0.0
        # step
        self.step_callback: Optional[Callable] = None
        self.step_file_key: Optional[str] = None
        self.step_file_count = 0
        self.step_recording = False
        self.step_h: List[float] = []
        self.step_x: List[float] = []
        self._step_y: Dict[int, List[float]] = {}
        self.step_global_error: List[float] = []
        # dense
        self.dense_callback: Optional[Callable] = None
        self.dense_file_key: Optional[str] = None
        self.dense_file_count = 0
        self.dense_recording = False
        self.dense_h_out: Optional[float] = None
        self.dense_index = 0
        self._dense_x: List[float] = []
        self._dense_y: Dict[int, List[float]] = {}
        # stiffness
        self.stiff_recording = False
        self.stiff_step_index: List[int] = []
        self._stiff_x: List[float] = []
        self._stiff_h_times_rho: List[float] = []
        # auxiliary
        self.yx_function: Optional[Callable] = None

    # -- setters (output.rs:182-366) -----------------------------------------

    def set_step_callback(self, cb: Callable) -> "Output":
        """cb(stats, h, x, y, args) -> bool(stop)."""
        self.step_callback = cb
        return self

    def set_step_file_writing(self, filepath_without_extension: str) -> "Output":
        self.step_file_key = filepath_without_extension
        return self

    def set_step_recording(self, selected_y_components) -> "Output":
        self.step_recording = True
        for m in selected_y_components:
            self._step_y.setdefault(int(m), [])
        return self

    def set_dense_h_out(self, h_out: float) -> "Output":
        if h_out <= 10.0 * EPS:
            raise ValueError("h_out must be > 10.0 * EPSILON")
        self.dense_h_out = float(h_out)
        return self

    def set_dense_x_out(self, interior_x_out) -> "Output":
        xs = [float(v) for v in interior_x_out]
        for k in range(1, len(xs)):
            if xs[k] < xs[k - 1]:
                raise ValueError("the dense output stations x must be sorted "
                                 "in ascending order in (x0, x1)")
            if xs[k] - xs[k - 1] <= 10.0 * EPS:
                raise ValueError("the x spacing must be > 10.0 * EPSILON")
        self._dense_x = [0.0] + xs + [0.0]
        self.dense_h_out = None
        return self

    def set_dense_callback(self, cb: Callable) -> "Output":
        self.dense_callback = cb
        return self

    def set_dense_file_writing(self, filepath_without_extension: str) -> "Output":
        if len(filepath_without_extension) < 4:
            raise ValueError("the length of the filepath without extension "
                             "must be at least 4")
        self.dense_file_key = filepath_without_extension
        return self

    def set_dense_recording(self, selected_y_components) -> "Output":
        self.dense_recording = True
        for m in selected_y_components:
            self._dense_y.setdefault(int(m), [])
        return self

    def set_yx_correct(self, y_fn_x: Callable) -> "Output":
        """y_fn_x(x, args) -> y array (analytical solution)."""
        self.yx_function = y_fn_x
        return self

    # -- getters -------------------------------------------------------------

    def step_y(self, m: int) -> List[float]:
        return self._step_y.get(m, [])

    def dense_x(self) -> List[float]:
        return self._dense_x

    def dense_y(self, m: int) -> List[float]:
        return self._dense_y.get(m, [])

    def stiff_x(self) -> List[float]:
        return self._stiff_x

    def stiff_h_times_rho(self) -> List[float]:
        return self._stiff_h_times_rho

    # -- solver interface (output.rs:423-560) --------------------------------

    def with_dense_output(self) -> bool:
        return (self.dense_callback is not None
                or self.dense_file_key is not None or self.dense_recording)

    def initialize(self, x0: float, x1: float, stiff_recording: bool):
        assert x1 > x0
        self.stiff_recording = stiff_recording
        if self.initialized:
            if self.step_recording:
                self.step_h.clear()
                self.step_x.clear()
                self.step_global_error.clear()
                for ym in self._step_y.values():
                    ym.clear()
            if self.stiff_recording:
                self.stiff_step_index.clear()
                self._stiff_x.clear()
                self._stiff_h_times_rho.clear()
        if self.with_dense_output():
            if self.dense_h_out is not None:
                n = max(2, int((x1 + EPS_X1_H_OUT - x0) / self.dense_h_out) + 1)
                self._dense_x = [x0 + i * self.dense_h_out for i in range(n)]
                self._dense_x[0] = x0
                self._dense_x[-1] = x1
            else:
                if len(self._dense_x) == 0:
                    self._dense_x = [0.0, 0.0]
                self._dense_x[0] = x0
                self._dense_x[-1] = x1
                n = len(self._dense_x)
                if n > 2:
                    if self._dense_x[1] <= x0:
                        raise ValueError("the first interior x_out for dense "
                                         "output must be > x0")
                    if self._dense_x[-2] >= x1:
                        raise ValueError("the last interior x_out for dense "
                                         "output must be < x1")
            n = len(self._dense_x)
            for m in self._dense_y:
                self._dense_y[m] = [0.0] * n
        self.x0 = x0
        self.x1 = x1
        self.initialized = True

    def execute(self, work, h: float, x: float, y, solver, args) -> bool:
        """Process an accepted step (y a tensor on the solver's device);
        returns True to stop gracefully."""
        assert self.initialized

        if self.step_callback is not None or self.step_file_key is not None:
            y_host = _host(y)
            if self.step_callback is not None:
                if self.step_callback(work.stats, h, x, y_host, args):
                    return True
            if self.step_file_key is not None:
                OutData(h, x, y_host).write_json(
                    f"{self.step_file_key}_{self.step_file_count}.json")
                self.step_file_count += 1
        if self.step_recording:
            self.step_h.append(h)
            self.step_x.append(x)
            for ym, v in zip(self._step_y.values(),
                             _selected(y, list(self._step_y))):
                ym.append(v)
            if self.yx_function is not None:
                y_ana = torch.as_tensor(np.asarray(
                    self.yx_function(x, args), dtype=np.float64),
                    device=y.device)
                self.step_global_error.append(float((y - y_ana).abs().max()))

        if self.with_dense_output():
            if work.stats.n_accepted == 0:
                self.dense_index = 0
                if self._dense_station(work, h, x, y, args):
                    return True
                self.dense_index = 1
            else:
                n_out = len(self._dense_x) - 1  # x1 handled by last()
                while self.dense_index < n_out:
                    x_out = self._dense_x[self.dense_index]
                    if x_out > x:
                        break
                    y_out = solver.dense_output(x_out, x, y, h)
                    if self._dense_station(work, h, x_out, y_out, args):
                        return True
                    self.dense_index += 1

        if self.stiff_recording:
            self._stiff_h_times_rho.append(work.stiff_h_times_rho)
            if work.stiff_detected:
                self.stiff_step_index.append(work.stats.n_accepted)
                self._stiff_x.append(work.stiff_x_first_detect)
        return False

    def _dense_station(self, work, h, x, y, args) -> bool:
        """Hand the station (x, y) to the dense callback, file and
        recording at ``dense_index``; returns the callback's stop."""
        if self.dense_callback is not None or self.dense_file_key is not None:
            y_host = _host(y)
            if self.dense_callback is not None:
                if self.dense_callback(work.stats, h, x, y_host, args):
                    return True
            if self.dense_file_key is not None:
                OutData(h, x, y_host).write_json(
                    f"{self.dense_file_key}_{self.dense_file_count}.json")
                self.dense_file_count += 1
        if self.dense_recording:
            for ym, v in zip(self._dense_y.values(),
                             _selected(y, list(self._dense_y))):
                ym[self.dense_index] = v
        return False

    def last(self, work, h: float, x: float, y, args):
        if self.step_file_key is not None:
            OutCount(self.step_file_count).write_json(
                f"{self.step_file_key}_count.json")
        if self.with_dense_output():
            if self.dense_callback is not None or \
                    self.dense_file_key is not None:
                y_host = _host(y)
                if self.dense_callback is not None:
                    self.dense_callback(work.stats, h, x, y_host, args)
                if self.dense_file_key is not None:
                    OutData(h, x, y_host).write_json(
                        f"{self.dense_file_key}_{self.dense_file_count}.json")
                    self.dense_file_count += 1
                    OutCount(self.dense_file_count).write_json(
                        f"{self.dense_file_key}_count.json")
            if self.dense_recording:
                for ym, v in zip(self._dense_y.values(),
                                 _selected(y, list(self._dense_y))):
                    ym[self.dense_index] = v
