"""Auxiliary subsystems: checkpoint/resume and profiling.

Counterpart of ``russell_tpu.utils``: ``CheckpointManager`` writes the
reference's ``.npz`` snapshot of (x, y, h, meta), so a snapshot written
by either package loads in the other; ``trace`` records a
``torch.profiler`` trace of the card (or of the CPU) into a directory.
"""

from russell_tpu_torch.utils.checkpoint import CheckpointManager
from russell_tpu_torch.utils.profiling import trace

__all__ = ["CheckpointManager", "trace"]
