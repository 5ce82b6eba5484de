#!/usr/bin/env python3
"""Variants of the clamped Gauss-Jordan kernel timed on one NVIDIA GPU: how
the design of ``russell_tpu_torch/csrc/gj_inv.cu`` was chosen.

Each variant is the kernel's source with a few lines replaced, compiled by
nvcc into ``build/variants/`` and launched through the same C entry point
on the (lanes, m) shapes of the base calls of the GRIDMF and SPLU plans
(diagonally dominant blocks with two zero pivots to clamp, as in
``chip_smoke.gj_inputs``). After one second of f64 GEMMs that wakes the
card's clocks, it prints one JSON line per (variant, shape): the device
time of one call back to back (``chip_smoke.time_ms``), its share of the
bound (``chip_smoke.gj_work``: the block read and written once, 2 m^3
flops a lane), whether Dinv, min|pivot|, n_perturbed and the sign have
the plain version's bits (``splu._gj_inv_plain``) and how far log|det|
is from its. The variants that keep the bits: ``r16_to_128`` runs 97 <=
m <= 128 in 8 slices of 16 rows (the design's 4 of 32), ``r24_to_64`` 49
<= m <= 64 in 3 of 24 (4 of 16), ``r34_to_136`` 129 <= m <= 136 in 4 of
34 (3 of 46), ``two_slices`` 97 <= m <= 144 in 2 of 64-72; ``late_loads``
holds the pivot column's loads back until the division is done;
``ddiv_zeros`` divides zeros too (``__ddiv_rn``'s slow path). The
diagnostic variants give other bits by design and split the time of a
step: ``fma`` (the update as one FMA), and ``no_publish``,
``no_rotation``, ``no_column``, ``no_update``, ``no_division`` and
``no_barrier``, each a part of every step left out. With ``--sass`` it
also writes the package kernel's SASS (cuobjdump) to
``build/russell_tpu_torch/variants/gj_inv.sass``; ``--only a,b`` runs the
variants named. Run from the repository root:

    python3 gj_inv_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from russell_tpu_torch.sparse import _cuda, splu

SOURCE = os.path.join(_cuda.CSRC, "gj_inv.cu")
OUT = os.path.join(_cuda.BUILD_DIR, "variants")
SHAPES = ((64, 16), (64, 32), (4096, 32), (1, 33), (8, 66), (64, 64),
          (16, 96), (1, 129), (64, 128), (4, 134), (2, 143), (1024, 128))

# name: [(text of the kernel source, its replacement)]
VARIANTS = {
    "final": [],
    # more slices of fewer rows, or fewer of more: the threads a lane takes
    "r16_to_128": [("launch<32, 512>", "launch<16, 1024>")],
    "r24_to_64": [("launch<16, 256>", "launch<24, 192>")],
    "r34_to_136": [("} else if (m <= 138) {\n    launch<46, 414>",
                    "} else if (m <= 136) {\n    launch<34, 544>")],
    # two slices of 64, 68 or 72 rows above m 96 (the design's 4 of 32,
    # 3 of 46 or 48)
    "two_slices": [("launch<32, 512>", "launch<64, 256>"),
                   ("} else if (m <= 138) {\n    launch<46, 414>",
                    "} else if (m <= 136) {\n    launch<68, 272>"),
                   ("launch<48, 432>", "launch<72, 288>")],
    # the pivot column's loads held back until the division is done
    "late_loads": [
        ("    const double2* f = reinterpret_cast",
         "    asm volatile(\"\" ::\"d\"(r) : \"memory\");\n"
         "    const double2* f = reinterpret_cast")],
    # every quotient by __ddiv_rn, zeros too
    "ddiv_zeros": [("const double r = quotient(k == j ? 1.0 : prow[b][k], p);",
                    "const double r = __ddiv_rn(k == j ? 1.0 : prow[b][k], p);")],
    # diagnostics, other bits by design: the update as one FMA, and one
    # part of a step left out: the publication of the next pivot row and
    # column (both, the rotation, the column), the update (one entry kept,
    # so the division stays), the division (an addition), the barrier
    "fma": [("W[q] = __dsub_rn(W[q], __dmul_rn(fq.x, r));\n"
             "      W[q + 1] = __dsub_rn(W[q + 1], __dmul_rn(fq.y, r));",
             "W[q] = fma(-fq.x, r, W[q]);\n"
             "      W[q + 1] = fma(-fq.y, r, W[q + 1]);")],
    "no_publish": [
        ("    publish(W, j + 1, j + 1 - i0, k, m, prow[b ^ 1], pcol[b ^ 1], i0);",
         "    if (m < 0) publish(W, j + 1, j + 1 - i0, k, m, prow[b ^ 1],"
         " pcol[b ^ 1], i0);")],
    "no_rotation": [("    if (qn > 0) {\n      const double w0 = W[0];",
                     "    if (qn < 0) {\n      const double w0 = W[0];")],
    "no_column": [("  if (k == jn) {\n#pragma unroll\n    for (int q = 0; q < R; ++q) {\n"
                   "      pcol[i0 + q] = W[q];",
                   "  if (k == jn && m < 0) {\n#pragma unroll\n    for (int q = 0; q < R;"
                   " ++q) {\n      pcol[i0 + q] = W[q];")],
    "no_update": [
        ("    for (int q = 0; q < R; q += 2) {\n      const double2 fq = f[q / 2];",
         "    for (int q = 0; q < 2; q += 2) {\n      const double2 fq = f[q / 2];")],
    "no_division": [
        ("const double r = quotient(k == j ? 1.0 : prow[b][k], p);",
         "const double r = (k == j ? 1.0 : prow[b][k]) + p;")],
    "no_barrier": [("    __syncthreads();\n    const double d = s_delta;",
                    "    const double d = s_delta;")],
}
EXACT = ("final", "r16_to_128", "r24_to_64", "r34_to_136", "two_slices",
         "late_loads", "ddiv_zeros")


def build(names):
    """Compile every variant, one nvcc each, all at once; returns {name:
    (entry point, ptxas lines)}."""
    src = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in "
                                 f"{SOURCE}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"gj_inv_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"libgj_inv_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(so).gj_inv_f64
        fn.argtypes = _cuda._SIGNATURES["gj_inv"]["gj_inv_f64"]
        fn.restype = ctypes.c_int
        out[name] = (fn, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main():
    cs.phase_device()
    names = (sys.argv[sys.argv.index("--only") + 1].split(",")
             if "--only" in sys.argv else list(VARIANTS))
    fns = build(names)
    for name, (_, ptxas) in fns.items():
        cs.say("variant_build", variant=name, ptxas=ptxas)
    a = torch.ones((4096, 4096), dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a @ a
        torch.cuda.synchronize()
    cs.say("clocks_after_warmup", nvidia_smi=clocks())
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    for w, m in SHAPES:
        D = cs.gj_inputs(w, m, w + m)
        want = splu._gj_inv_plain(D, delta)
        b_ms = cs.bound(*cs.gj_work(w, m))[0]
        for name, (fn, _) in fns.items():
            outs = [torch.empty_like(D)] + [
                torch.empty(w, dtype=t, device="cuda") for t in (
                    torch.float64, torch.float64, torch.int32,
                    torch.float64)]

            def launch(fn=fn, outs=outs):
                _cuda.launch_check(name, fn(
                    D.data_ptr(), D.stride(0), D.stride(1), delta.data_ptr(),
                    w, m, *(o.data_ptr() for o in outs),
                    _cuda.stream_of(D)))
            launch()
            torch.cuda.synchronize()
            same = all(torch.equal(g, p) for g, p in zip(
                [outs[0], outs[2], outs[3], outs[4]],
                [want[0], want[2], want[3], want[4]]))
            ld_rel = float(((outs[1] - want[1]).abs()
                            / want[1].abs()).max())
            ms = cs.time_ms(launch, reps=5 if w >= 1024 else 20)
            print(json.dumps({"variant": name, "w": w, "m": m, "ms": ms,
                              "us_per_step": 1e3 * ms / m,
                              "share": b_ms / ms, "bit_identical": same,
                              "logdet_rel_err": ld_rel}), flush=True)
            if name in EXACT and not same:
                raise AssertionError(f"{name} at ({w}, {m}): other bits")
    cs.say("clocks_after", nvidia_smi=clocks())
    if "--sass" in sys.argv:
        with open(os.path.join(OUT, "gj_inv.sass"), "w") as f:
            subprocess.run([os.path.join(os.path.dirname(_cuda._nvcc()),
                                         "cuobjdump"), "-sass",
                            _cuda.build("gj_inv")], stdout=f, check=True,
                           timeout=300)


if __name__ == "__main__":
    main()
