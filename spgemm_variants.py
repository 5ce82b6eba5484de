#!/usr/bin/env python3
"""Variants of the SpGEMM kernel timed on one NVIDIA GPU: how the design
of ``russell_tpu_torch/csrc/spgemm_blocks.cu`` was chosen.

Each variant is the kernel's source with a few lines replaced (a constant,
the store instruction, the order of the block rows, or a phase left out),
compiled by nvcc into ``build/variants/`` and launched through the same C
entry point on the npoint-513 Brusselator Jacobian's A·A in 16x16 blocks,
with the operands' RowLayouts and the device plan the package builds. It
prints one JSON line per variant: the L2-cold and back-to-back device
times (``chip_smoke.cold_ms`` / ``time_ms``), the share of the live bound
(``chip_smoke.spgemm_work``), and whether C has the package kernel's bits;
before them, the package's own time, ``C.zero_()`` on a tensor of C's
size (the card's rate of writing C alone) and ``torch.sparse.mm``. The
diagnostic variants ``walk_only`` (C is not written) and ``store_only``
(nothing is summed) give wrong C by design; they split the time between
the walk and the stores. Run from the repository root:

    python3 spgemm_variants.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

import chip_smoke as cs
from russell_tpu_torch.sparse import (_cuda, bsr_from_coo, kernels, spgemm,
                                      spgemm_plan)

SOURCE = os.path.join(_cuda.CSRC, "spgemm_blocks.cu")
OUT = os.path.join(_cuda.BUILD_DIR, "variants")

# name: [(text of the kernel source, its replacement)]
VARIANTS = {
    "final": [],
    "turns_2": [("constexpr int kTurns = 4;", "constexpr int kTurns = 2;")],
    "turns_8": [("constexpr int kTurns = 4;", "constexpr int kTurns = 8;")],
    # block rows blockIdx.x * kTurns + turn: the CTAs on the card at one
    # time write runs of C kTurns block rows apart
    "contiguous_rows": [
        ("((long long)n_block_rows - blockIdx.x + gridDim.x -\n"
         "                          1) / (long long)gridDim.x);",
         "(long long)n_block_rows - (long long)blockIdx.x * kTurns);"),
        ("    const long long i = blockIdx.x + (long long)turn * gridDim.x;",
         "    const long long i = (long long)blockIdx.x * kTurns + turn;")],
    "plain_stores": [("      __stcs(d2 + e, v);", "      d2[e] = v;")],
    # one set of all eight warps: no hand-over, no load overlapped
    "one_set": [("constexpr int kSets = 2;", "constexpr int kSets = 1;"),
                ("        else if (turn > 0) strip_acquire(set);", ""),
                ("    if (!held && turn > 0) strip_acquire(set);\n"
                 "    if (turn + 1 < turns) strip_release(set);", "")],
    "store_unroll_4": [
        ("    double2* s2 = reinterpret_cast<double2*>(src);\n"
         "    for (int e = stid; e < n2; e += kSetThreads) {",
         "    double2* s2 = reinterpret_cast<double2*>(src);\n"
         "#pragma unroll 4\n"
         "    for (int e = stid; e < n2; e += kSetThreads) {")],
    "walk_only": [("        store_run(dst, strip, n, stid);",
                   "        if (n < 0) store_run(dst, strip, n, stid);")],
    "store_only": [("        for (int rb = 0; rb < nr; rb += kGroups) {",
                    "        for (int rb = 0; nr < 0; rb += kGroups) {")],
}
# store_only with one set: the stores of a strip by eight warps, not four
VARIANTS["one_set_store_only"] = VARIANTS["one_set"] + VARIANTS["store_only"]


def build(names):
    """Compile every variant, one nvcc each, all at once; returns {name:
    entry point}."""
    src = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   f"{SOURCE}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).spgemm_blocks_f64
        fn.argtypes = _cuda._SIGNATURES["spgemm_blocks"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
        cs.say("variant_build", variant=name, ptxas=[
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])
    return fns


def main():
    cs.phase_device()
    fns = build(VARIANTS)
    dev = torch.device("cuda")
    coo = cs.brusselator_jacobian(cs.NPOINT_BSR)
    bsr = bsr_from_coo(coo, 16, 16, dev)
    plan = spgemm_plan(bsr, bsr)
    want = spgemm(plan, bsr, bsr)[0]
    lay = kernels._spgemm_layout(bsr)
    dp = kernels._device_plan(plan, dev)
    rows, blocks = kernels._strip_chunks(16, 16, dp["max_row_blocks"])
    b_ms = cs.bound(*cs.spgemm_work(plan, bsr, bsr))[0]
    a_csr = cs.torch_csr(cs.scipy_csr(coo), dev)
    C = torch.empty_like(want)
    cs.say("variant_yardsticks", bound_ms=b_ms, C_GB=C.numel() * 8 / 1e9,
           package_ms=cs.cold_ms(lambda: spgemm(plan, bsr, bsr)),
           zero_ms=cs.cold_ms(C.zero_),
           library_ms=cs.cold_ms(lambda: torch.sparse.mm(a_csr, a_csr)))
    del a_csr
    torch.cuda.empty_cache()
    for name, fn in fns.items():
        def launch(fn=fn):
            _cuda.launch_check(name, fn(
                lay.row_ptr.data_ptr(), lay.col.data_ptr(),
                lay.val.data_ptr(), lay.row_ptr.data_ptr(),
                lay.col.data_ptr(), lay.val.data_ptr(), lay.n_rows,
                dp["c_row_ptr"].data_ptr(), dp["c_col"].data_ptr(),
                dp["nbr"], 16, 16, rows, blocks, C.data_ptr(),
                _cuda.stream_of(C)))
        C.fill_(float("nan"))
        launch()
        torch.cuda.synchronize()
        ms = cs.cold_ms(launch)
        cs.say("variant", variant=name, ms=ms, ms_warm_l2=cs.time_ms(launch),
               share=b_ms / ms, same_bits=bool(torch.equal(C, want)))


if __name__ == "__main__":
    main()
