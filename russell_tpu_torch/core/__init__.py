"""Core utilities of the port: the stopwatch the solver statistics use
(copied from ``russell_tpu.core.stopwatch``)."""

from russell_tpu_torch.core.stopwatch import Stopwatch, format_nanoseconds

__all__ = ["Stopwatch", "format_nanoseconds"]
