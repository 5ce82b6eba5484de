"""Native (C++) host symbolic engine, built at first use.

The same engine as ``russell_tpu.native``: ``symbolic.cpp`` here is a copy
of that package's source, so both packages compute identical orderings,
block fills and therefore identical SPLU plans. The first call compiles it
with the system g++ into ``build/russell_tpu_torch/`` at the repository
root (an ignored directory, never beside the source); without a toolchain
the callers use the pure-Python paths of ``sparse/ordering.py`` and
``sparse/splu.py``, which have the same contracts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

__all__ = ["load", "rcm_order", "mindeg_order", "nd_order", "block_fill", "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "symbolic.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "russell_tpu_torch")
_SO = os.path.join(BUILD_DIR,
                   f"_symbolic_{sys.implementation.cache_tag}.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime:
            return True
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
               "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    I64 = ctypes.c_int64
    P64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.rcm_order.argtypes = [I64, I64, P64, P64, P64]
    lib.rcm_order.restype = ctypes.c_int
    lib.mindeg_order.argtypes = [I64, I64, P64, P64, P64]
    lib.mindeg_order.restype = ctypes.c_int
    lib.nd_order.argtypes = [I64, I64, P64, P64, I64, P64, P64,
                             ctypes.POINTER(I64)]
    lib.nd_order.restype = ctypes.c_int
    lib.block_fill.argtypes = [I64, I64, P64, P64, I64, P64]
    lib.block_fill.restype = I64
    _lib = lib
    return _lib


def rcm_order(n: int, rows, cols) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    if lib.rcm_order(n, len(rows), rows, cols, out) != 0:
        return None
    return out


def mindeg_order(n: int, rows, cols) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    if lib.mindeg_order(n, len(rows), rows, cols, out) != 0:
        return None
    return out


def nd_order(n: int, rows, cols, leaf: int = 64, with_regions: bool = False):
    """order array, or (order, region_sizes) when with_regions; None if the
    native engine is unavailable."""
    lib = load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    regions = np.empty(max(n, 1), dtype=np.int64)
    nreg = ctypes.c_int64(0)
    if lib.nd_order(n, len(rows), rows, cols, leaf, out, regions,
                    ctypes.byref(nreg)) != 0:
        return None
    if with_regions:
        return out, regions[:nreg.value].copy()
    return out


def block_fill(nb: int, bi, bj) -> Optional[np.ndarray]:
    """Final block pattern (with fill) as (i, j) pairs, or None."""
    lib = load()
    if lib is None:
        return None
    bi = np.ascontiguousarray(bi, dtype=np.int64)
    bj = np.ascontiguousarray(bj, dtype=np.int64)
    cap = max(16, min(nb * nb, 64 * (len(bi) + nb)))
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib.block_fill(nb, len(bi), bi, bj, cap, out)
        if got >= 0:
            codes = out[:got]
            return np.stack([codes // nb, codes % nb], axis=1)
        if cap >= nb * nb:
            return None
        cap = min(nb * nb, cap * 4)
