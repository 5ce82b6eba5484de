"""Whitespace-table file readers (reference: russell_lab/src/base/read_table.rs:47,115).

``read_data`` returns a 2D float array; ``read_table`` returns a dict of
named columns keyed by the header labels (or provided labels).

Counterpart of ``russell_tpu.core.read_table``, copied: host numpy, as in
the reference.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_data", "read_table"]


def _data_lines(path: str):
    with open(path, "r") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            yield line


def read_data(path: str) -> np.ndarray:
    """Read a whitespace-separated numeric table into an (nrow, ncol) array.

    Blank lines and '#' comments are skipped. Raises ValueError on ragged rows.
    """
    rows = []
    ncol = None
    for line in _data_lines(path):
        parts = line.split()
        try:
            vals = [float(p) for p in parts]
        except ValueError as e:
            raise ValueError(f"cannot parse line {line!r}: {e}") from None
        if ncol is None:
            ncol = len(vals)
        elif len(vals) != ncol:
            raise ValueError("inconsistent number of columns")
        rows.append(vals)
    if not rows:
        return np.zeros((0, 0))
    return np.array(rows)


def read_table(path: str, labels=None) -> dict:
    """Read a table whose first non-comment line holds the column labels;
    returns {label: np.ndarray column}. When ``labels`` is given, the
    header is VALIDATED against it (read_table.rs:156-166 semantics)."""
    lines = list(_data_lines(path))
    if not lines:
        raise ValueError("file has no header line")
    header = lines[0].split()
    lines = lines[1:]
    if labels is None:
        if len(set(header)) != len(header):
            raise ValueError("found duplicate column label")
        labels = header
    else:
        if len(header) > len(labels):
            raise ValueError("there are more columns than labels")
        if list(header) != list(labels):
            raise ValueError("column data is missing")
    cols = {lab: [] for lab in labels}
    for line in lines:
        parts = line.split()
        if len(parts) != len(labels):
            raise ValueError("inconsistent number of columns")
        for lab, p in zip(labels, parts):
            cols[lab].append(float(p))
    return {lab: np.array(v) for lab, v in cols.items()}
