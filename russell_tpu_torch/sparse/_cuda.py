"""Build and load the port's CUDA kernels.

Each kernel is one source ``russell_tpu_torch/csrc/<name>.cu`` with a plain
C entry point. At its first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/russell_tpu_torch/lib<name>.so`` at the
repository root (an ignored directory) and loaded with ``ctypes``; it is
rebuilt when the source is newer than the library. ``build_all`` starts
one ``nvcc`` per source, all at once. Nothing here runs when the module is
imported, so the CPU tests, which have no ``nvcc``, import it freely. The
wrappers that launch the kernels live beside their plain PyTorch versions
(``sparse/splu.py``, ``sparse/kernels.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from russell_tpu_torch.native import BUILD_DIR

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "build",
           "build_all", "library", "build_info", "stream_of", "launch_check"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point and argument types of each kernel library; every entry
# point returns a cudaError_t code
_SIGNATURES = {
    "splu_pairs": ("splu_pairs_f64", [_P, _P, _P, _P, _I, _I, _P, _P]),
    "gather_rows": ("gather_rows_f64", [_P, _P, _I, _I, _P, _P]),
    "bsr_spmv": ("bsr_spmv_f64",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "bsr_spmm": ("bsr_spmm_f64",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "spgemm_blocks": ("spgemm_blocks_f64",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
}
KERNELS = tuple(_SIGNATURES)

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


def build_all(names=KERNELS) -> dict:
    """Compile ``csrc/<name>.cu`` for each of ``names`` that has no
    up-to-date library, one ``nvcc`` per source, all started together;
    returns {name: library path}. Raises with nvcc's output on failure."""
    out, jobs = {}, {}
    for name in names:
        src, so = _paths(name)
        out[name] = so
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(
                src):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
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
        fn_name, argtypes = _SIGNATURES[name]
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
