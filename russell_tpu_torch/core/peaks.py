"""Valley/peak detection (reference: russell_lab/src/base/find_valleys_and_peaks.rs:49).

Counterpart of ``russell_tpu.core.peaks``, copied: host numpy, as in the
reference (a tensor is brought to the host)."""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.core._place import host

__all__ = ["find_valleys_and_peaks"]


def find_valleys_and_peaks(y):
    """Return (valleys, peaks): indices of strict local minima/maxima of ``y``.

    Endpoints are not counted. Plateaus are skipped (no strict extremum).
    """
    yy = np.asarray(host(y), dtype=np.float64).ravel()
    valleys, peaks = [], []
    for i in range(1, len(yy) - 1):
        if yy[i] < yy[i - 1] and yy[i] < yy[i + 1]:
            valleys.append(i)
        elif yy[i] > yy[i - 1] and yy[i] > yy[i + 1]:
            peaks.append(i)
    return valleys, peaks
