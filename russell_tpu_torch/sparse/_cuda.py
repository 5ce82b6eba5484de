"""Build and load the port's CUDA kernels.

Each kernel is one source ``russell_tpu_torch/csrc/<name>.cu`` with plain
C entry points. At its first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/russell_tpu_torch/lib<name>.so`` at the
repository root (an ignored directory) and loaded with ``ctypes``; it is
rebuilt when the source or a header of ``csrc/`` is newer than the
library. ``build_all`` starts
one ``nvcc`` per source, all at once, one process of the machine at a
time. Nothing here runs when the module is
imported, so the CPU tests, which have no ``nvcc``, import it freely. The
wrappers that launch the kernels live beside their plain PyTorch versions
(``sparse/splu.py``, ``sparse/kernels.py``, ``dense/matrix_ops.py``). A
kernel for several value types has one C entry point for each
(``<name>_f64``, ``<name>_c128``; ``<name>_f32`` for the mixed-precision
factors' three).
``KERNELS`` are the ports of the reference's TPU kernels (and of its
clamped inverse); ``LIBRARIES`` adds the fused ODE loops' two:
``graph_cond``, CUDA graph conditional nodes (``ode/_device_loop.py``),
and ``lane_pow``, the controllers' correctly rounded pow
(``ode/_lanes.py``). ``jacobi_eig`` (``dense/matrix_ops.py``) ports the
reference's plain-XLA Jacobi eigensolver.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time

import torch

from russell_tpu_torch.native import BUILD_DIR

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "LIBRARIES", "build",
           "build_all", "library", "build_info", "stream_of", "launch_check"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SPMV = [_P, _P, _P, _P, _I, _I, _P, _P]
_SPMM = [_P, _P, _P, _P, _I, _I, _I, _P, _P]
_SPGEMM = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P]
_PAIRS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _P, _P, _P]
_GATHER = [_P, _P, _I, _I, _I, _L, _P, _P]
_GJ = [_P, _L, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
# C entry points of each kernel library and their argument types (one per
# value type where the kernel has several); every entry point returns a
# cudaError_t code
_SIGNATURES = {
    # blocks, pair_l, pair_u, chunk, lane_off, tickets, n_chunks, n_live,
    # n_multi, be, lanes, blocks' lane stride, out, scratch, stream
    "splu_pairs": {"splu_pairs_f64": _PAIRS, "splu_pairs_f32": _PAIRS},
    # src, idx, n_rows, width, lanes, src's lane stride, out, stream
    "gather_rows": {"gather_rows_f64": _GATHER, "gather_rows_f32": _GATHER},
    # val, col, slice_off, x, n_rows, n_slices, y, stream
    "bsr_spmv": {"bsr_spmv_f64": _SPMV, "bsr_spmv_c128": _SPMV},
    # val, col, slice_off, X, n_rows, n_slices, m, Y, stream
    "bsr_spmm": {"bsr_spmm_f64": _SPMM, "bsr_spmm_c128": _SPMM},
    # a_ptr, a_col, a_val, b_ptr, b_col, b_val, b_rows, c_row_ptr, c_col,
    # n_block_rows, bm, bn, chunk_rows, chunk_blocks, C, stream
    "spgemm_blocks": {"spgemm_blocks_f64": _SPGEMM,
                      "spgemm_blocks_c128": _SPGEMM},
    # D, lane stride, row stride, delta, n_delta, w, m, Dinv, log|det|,
    # min|pivot|, n_perturbed, sign, stream
    "gj_inv": {"gj_inv_f64": _GJ, "gj_inv_f32": _GJ},
    # parent stream, child stream, pred, capture mode, body graph out;
    # child stream; graph, count out; capturing stream, count out
    "graph_cond": {"cond_if_begin": [_P, _P, _P, _I, _P],
                   "cond_if_end": [_P],
                   "graph_node_count": [_P, _P],
                   "capture_node_count": [_P, _P]},
    # x, exponent, n, out, stream
    "lane_pow": {"pow_cr_f64": [_P, ctypes.c_double, _I, _P, _P]},
    # a, n, sweeps, cluster, shared route, work, work doubles, w, V,
    # stream; n, cluster, shared route, smem bytes out, work doubles out,
    # active launches out (or null)
    "jacobi_eig": {"jacobi_eig_f64": [_P, _I, _I, _I, _I, _P, _L, _P, _P,
                                      _P],
                   "jacobi_eig_plan": [_I, _I, _I, _P, _P, _P]},
}
LIBRARIES = tuple(_SIGNATURES)
# the fused loops' graph conditional nodes and their controllers' pow
_LOOP_LIBRARIES = ("graph_cond", "lane_pow")
KERNELS = tuple(n for n in LIBRARIES if n not in _LOOP_LIBRARIES)

_libs: dict = {}
_build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc is not on PATH nor under CUDA_HOME: the "
                           "CUDA kernels cannot be built")
    return path


def _paths(name):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def build_all(names=LIBRARIES) -> dict:
    """Compile ``csrc/<name>.cu`` for each of ``names`` that has no
    up-to-date library, one ``nvcc`` per source, all started together;
    returns {name: library path}. Raises with nvcc's output on failure.

    Processes that start together on one machine (the ranks of a
    ``parallel`` group) build one at a time under an exclusive lock on
    ``build.lock`` in the build directory: the first compiles, the others
    then find the libraries up to date. Each library is compiled to a
    temporary name and moved into place, so a library being loaded is
    never half written. The lock ends with its process."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_unlocked(names)


def _build_unlocked(names) -> dict:
    out, jobs = {}, {}
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    for name in names:
        src, so = _paths(name)
        out[name] = so
        newest = max(os.path.getmtime(f) for f in [src, *headers])
        if os.path.exists(so) and os.path.getmtime(so) >= newest:
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        jobs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, t0, proc) in jobs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {_paths(name)[0]}:\n{log}")
            continue
        os.replace(tmp, out[name])
        _build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path. Raises with nvcc's output on failure."""
    return build_all([name])[name]


def build_info(name: str) -> dict:
    """Seconds and nvcc output (with ``-Xptxas -v``: registers, shared
    memory, spills) of this process's build of ``name``; empty when the
    library was already up to date."""
    return dict(_build_info.get(name, {}))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the int a kernel entry
    point takes; raises if ``t`` is not on the current CUDA device."""
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_check(name, rc):
    """Raise if a kernel entry point returned a cudaError_t other than 0."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
