"""Build and load the port's CUDA kernels.

Each kernel is one source ``russell_tpu_torch/csrc/<name>.cu`` with a plain
C entry point. At its first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/russell_tpu_torch/lib<name>.so`` at the
repository root (an ignored directory) and loaded with ``ctypes``; it is
rebuilt when the source is newer than the library. Nothing here runs when
the module is imported, so the CPU tests, which have no ``nvcc``, import
it freely. The wrappers that launch the kernels live beside their plain
PyTorch versions (``sparse/splu.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

from russell_tpu_torch.native import BUILD_DIR

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "build_info"]

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
}

_libs: dict = {}
_build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc is not on PATH nor under CUDA_HOME: the "
                           "CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path. Raises with nvcc's output on failure."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, so)
    _build_info[name] = {"seconds": time.perf_counter() - t0,
                         "log": res.stdout + res.stderr}
    return so


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
