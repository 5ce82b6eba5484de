"""Profiling hooks.

Counterpart of ``russell_tpu.utils.profiling``: ``trace`` records the
host and device activity of its block with ``torch.profiler`` and writes
a Chrome/TensorBoard trace (``*.pt.trace.json``) into ``log_dir``. A
profiler that cannot start raises; there is no silent no-op.
"""

from __future__ import annotations

import contextlib

from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

import russell_tpu_torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Context manager around ``torch.profiler.profile``: CPU and CUDA
    activity on the card (``device="cuda"``, the default; raises without
    one), CPU activity only with ``device="cpu"``. Yields the profiler
    (``key_averages()`` and the like); the trace file is written into
    ``log_dir`` when the block ends. View it with TensorBoard or
    chrome://tracing."""
    activities = [ProfilerActivity.CPU]
    if russell_tpu_torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
