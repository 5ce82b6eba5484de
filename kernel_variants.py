"""What the variants scripts (``gj_inv_variants.py``, ``jacobi_variants.py``)
share: patched copies of a kernel's source compiled side by side, the
card's clocks, and the warm-up before timing.

A variants script names a kernel source ``russell_tpu_torch/csrc/<stem>.cu``,
its C entry point and a table {variant: [(text of the source, its
replacement)]}; ``start`` compiles the variants that ``--only a,b`` names
(all by default) and each ``--source name=path`` (a whole other source
with the same entry point), wakes the card and returns the entry points.
The script then launches each on its own shapes against the kernel's plain
version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from russell_tpu_torch.sparse import _cuda

OUT = os.path.join(_cuda.BUILD_DIR, "variants")


def build(stem, entry, variants, names, sources=None):
    """Compile each variant of ``csrc/<stem>.cu`` in ``names`` (its patches
    from ``variants``) and each of ``sources`` ({name: path}) into OUT, one
    nvcc each, all at once; returns {name: (the entry point ``entry`` with
    the package's argument types, ptxas lines)}. Raises where a patch's
    text is not in the source or nvcc fails."""
    sources = sources or {}
    path = os.path.join(_cuda.CSRC, f"{stem}.cu")
    src = open(path).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in [*names, *sources]:
        if name in sources:
            text = open(sources[name]).read()
        else:
            text = src
            for old, new in variants[name]:
                if old not in text:
                    raise ValueError(f"variant {name}: {old!r} is not in "
                                     f"{path}")
                text = text.replace(old, new)
        cu = os.path.join(OUT, f"{stem}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{stem}_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _cuda._SIGNATURES[stem][entry]
        fn.restype = ctypes.c_int
        out[name] = (fn, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def clocks():
    """The card's SM clock, its maximum and the power drawn (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def start(stem, entry, variants):
    """The card's record (``chip_smoke.phase_device``), the variants built
    as the command line asks (their ptxas lines printed), then one second
    of f64 GEMMs that wakes the card's clocks; returns ``build``'s
    {name: (entry point, ptxas lines)}."""
    cs.phase_device()
    argv = sys.argv
    names = (argv[argv.index("--only") + 1].split(",")
             if "--only" in argv else list(variants))
    sources = dict(arg.split("=", 1) for i, arg in enumerate(argv)
                   if i and argv[i - 1] == "--source")
    fns = build(stem, entry, variants, names, sources)
    for name, (_, ptxas) in fns.items():
        cs.say("variant_build", variant=name, ptxas=ptxas)
    a = torch.ones((4096, 4096), dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a @ a
        torch.cuda.synchronize()
    cs.say("clocks_after_warmup", nvidia_smi=clocks())
    return fns
