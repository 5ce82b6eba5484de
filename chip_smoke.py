#!/usr/bin/env python3
"""Smoke run of russell_tpu_torch on one NVIDIA GPU.

Drives the port's paths and checks them. The main path is Radau5 on the
2-D Brusselator PDE: with default Params (genie AUTO), which routes it to
GRIDMF, whose pivot-block inverses run the CUDA kernel ``gj_inv``; and
through the SPLU solver, whose factorize rows run ``splu_pairs``,
``gather_rows`` and ``gj_inv``. The ODE surface beside it: the Fortran
oracles on the card, DoPri5/DoPri8 on the Brusselator, BwEuler through
GRIDMF and Radau5 through the DENSE route. The BSR path is the sparse products of
``russell_tpu_torch.sparse`` — ``bsr_from_coo`` → ``bsr_matvec`` /
``bsr_matmat`` and ``spgemm_plan`` → ``spgemm`` — whose CUDA kernels are
``bsr_spmv``, ``bsr_spmm`` and ``spgemm_blocks``, in float64 and
complex128.

1. device: the card's name and power limit (nvidia-smi);
2. build: all six kernels compiled from ``russell_tpu_torch/csrc``, one
   nvcc per source, all at once, with ptxas' register and spill lines;
3. warmup: factorize pairs back to back for WARM_S seconds, so that no
   timing below is the card's first work;
4. kernels: each SPLU kernel against its plain PyTorch version on the
   card, at the shapes of four rows of the npoint-129 plan (the most
   pairs, the most live lanes, the longest lane, the median len), with
   its device time (``time_ms``, calls back to back, L2 warm; and
   ``cold_ms``, L2 flushed before each call) beside its bound on the
   live-lanes contract and on the earlier all-TL-lanes one, the plain
   version's time and the library call's; then the W-1024 and W-4096
   timings in both orders, one call at a time (``call_ms``) and back to
   back;
5. the van der Pol oracle: all nine radau5.f counters, exactly;
6. the npoint-16 Brusselator: the reference package's counters, exactly,
   through SPLU (``brusselator_16``) and through GRIDMF (``gridmf_16``);
7. the SPLU main path: npoint 129, tolerances 1e-4, t in [0, 1], cold and
   warm, with each kernel's launch count from that run and its counters
   held to 237/21/27/70/27/25/1;
8. layers: one SPLU factorize pair, one solve pair and the diagonal-block
   inversion of one row, timed per call on the npoint-129 matrix;
9. gridmf_main_path: the same integration with default Params (AUTO →
   GRIDMF), cold and three warm runs (median and spread), gj_inv's
   launches counted from 0 in each run, counters held to the SPLU run's
   (or, where they differ, y to rtol 1e-6 of its y);
10. gridmf_layers: at npoint 129 and 513 one GRIDMF factorize pair and one
   solve pair: walls, device time and device launches under the profiler,
   GFLOP/s, peak memory, residuals max|A x - b| / max|b| <= 1e-10 of the
   real and the complex system; then the leaf sweep (16, 32, 64 cells);
11. gj_inv: the kernel against its plain version at every (w, m) of its
   base calls (the blocks ``splu._inv_block`` does not split, m <=
   ``splu.GJ_MAX_M``) in an npoint-129 SPLU pair and npoint-129 and 513
   GRIDMF pairs (513 also at leaf 16: up to 4,096 lanes), with zero
   pivots to clamp: Dinv bit-identical, min|pivot|, n_perturbed and sign
   exact, log|det| at rtol 1e-14; then per factorize pair (GRIDMF 129 and
   513, SPLU 129) the kernel's device time and launches and
   _inv_block's (the kernel, the recursion's GEMMs and cats), beside the
   bound of the pair's top-level pivot blocks and torch.linalg.inv_ex on
   them; and at the npoint-129 GRIDMF pair's base calls the kernel's
   L2-cold time, its plain version's and inv_ex's;
12. replay: one whole SPLU factorize pair under torch.profiler: each SPLU
   kernel's summed device time beside the bound of the same work, and
   the pair's device launches;
13. ode_samples: the radau5.f, dopri5.f, dop853.f and Euler oracles of
   tests/test_ode.py on the card with the default genie AUTO (DENSE for
   these systems): Radau5 on van der Pol, Robertson, Hairer-Wanner eq. 1
   and amplifier1t, DoPri5 on Hairer-Wanner and Arenstorf, DoPri8 on van
   der Pol, BwEuler and MdEuler on Hairer-Wanner; counters exact, y
   within the tolerances given there;
14. erk_path: DoPri5 and DoPri8 on the npoint-129 Brusselator (tolerances
   1e-4, t in [0, 1]) with stiffness detection recorded and dense stations
   every 0.1, on the card and on the CPU in this run: counters exact, y
   and stations at rtol 1e-10; then DoPri5 on the npoint-513 Brusselator
   on the card (y finite); each with its steps, wall, device launches per
   step and device busy share (profiled; at npoint 513 over the window t
   in [0, ERK_WINDOW_X1]) and where stiffness was detected;
15. bweuler_path: BwEuler on the npoint-129 Brusselator with default
   Params (AUTO → GRIDMF, so ``gj_inv`` runs) at equal steps of
   BWEULER_H: counters, wall, factorizations, ``gj_inv`` launches, y
   finite, and the last Newton solve's residual <= 1e-10;
16. dense_factor: Radau5 with default Params on the npoint-24 Brusselator
   (ndim 1,152 <= dense_threshold: AUTO → DENSE, grid hint or not) on the
   card and on the CPU (counters exact, y at rtol 1e-10); one factorize
   pair at the replay's shifts: residuals <= 1e-12, log|det|, min|pivot|
   and sign at rtol 1e-12 of the CPU's, the pair's and a solve pair's
   times per call;
17. bsr_kernels: each BSR kernel against its plain version on the card on
   the npoint-129 Brusselator Jacobian (8x128 blocks for SpMV and SpMM at
   m = 16, 16x16 blocks for A·A): the kernel's, the plain version's and
   the library call's time with the L2 flushed before each call (``ms``:
   at npoint 513 SpMV's whole working set fits the 50 MB L2, so only the
   cold time reads HBM as the bound assumes), the kernel's and library's
   back-to-back time beside it (``ms_warm_l2``), and the bound; SpMV and
   SpMM read the matrix's live-entry layout, whose build (``layout_s``,
   the first bsr_matvec), bytes and pad share are printed, and are held
   to the least bytes of the work (``bsr_work``: each nonzero once, the
   layout's slice offsets, x and y once) beside the bound over the stored
   8x128 blocks they were held to before (``stored_bound_ms``); SpGEMM
   reads its operands' live entries (a RowLayout built by the first
   spgemm on a matrix: ``first_call_s``, and ``updated_call_s`` after an
   in-place update of the blocks) and is held to the least bytes of its
   output form (``spgemm_work``: the live entries once, C written once)
   beside the bound over stored blocks (``stored_bound_ms``); two more
   launches of each kernel must give the same bits;
18. bsr_path: the BSR path through the public entry points on the
   npoint-513 Brusselator Jacobian J(y0) (n 526,338), with launch counts
   and peak device memory; then each product held against its kernel's
   plain version on the same inputs (every entry) and against scipy on
   the host, with the numbers of phase 17, nnz/s, GB/s and roofline share
   at these shapes. The kernels line reports the BSR kernels from this
   phase: measured numbers and the bound only (shares, the stored-block
   bounds, the layouts and first calls stay in the phase's lines);
19. bsr_complex: the three BSR products on complex128 matrices (J(y0) +
   0.3 i noise at npoint 129 and 513), each against its plain version and
   scipy, launched twice more for bit identity, timed as in phase 17; the
   kernels line carries the npoint-513 numbers under ``complex128``;
20. fused_path: ``solve(..., fused=True)`` and ``solve_batch``, the whole
   integration on the card as one captured CUDA graph per step attempt
   (conditional nodes for the skipped work, a done flag read every
   ``_device_loop.REPLAYS_PER_READ`` replays): the torch and CUDA
   versions; radau5.f's van der Pol and Robertson counters through DENSE,
   exactly; the bench.py configuration (default Params, AUTO -> GRIDMF,
   npoint 129) cold (warm-up, capture and instantiation shown apart) and
   FUSED_WARM_RUNS warm, with its nodes per step attempt (``gj_inv``'s
   too), replays, flag reads and device busy share (profiled device time
   over the warm median wall) beside phase 9's host-stepped walls,
   counters equal to phase 9's and y at atol 1e-12 of its y; the same
   run captured anew and replayed with one replay per flag read:
   bit-identical y and counters; SPLU at npoint 129 against phase 7
   (nodes of ``splu_pairs``, ``gather_rows``, ``gj_inv``); GRIDMF at
   npoint 513 against a host-stepped run in this phase (counters equal, y
   at atol 1e-10, walls, peak memory); DoPri5 at npoint 513 against
   phase 14's run (counters, y at rtol 1e-10; busy share over the window
   t in [0, ERK_WINDOW_X1]); DoPri8 at npoint 129 with dense stations
   every 0.1 against a host-stepped run (stations at atol 1e-10);
   ``solve_batch`` of FUSED_BATCH van der Pol lanes (DENSE) and of
   FUSED_BATCH DoPri5 Hairer-Wanner lanes, each lane held to a single
   fused solve (y at atol 1e-12, counters equal). Each kernel of the
   kernels line gains its nodes per captured attempt and its launches in
   the cold fused runs (``fused_path``).
21. lin_solver_path: ``LinSolver`` on the card at the reference's sparse
   benchmark sizes, each result held to SciPy's SuperLU on the host (x,
   log|det| and the determinant's sign or complex phase): GENMF on
   geometric_264k (``samples.irregular_geometric(263_743)``, seed 0,
   ``Genie.GENMF`` by name as the reference's benchmark runs it; AUTO's
   own route is recorded) with the host analysis, a cold and three warm
   factorizations (walls, device ms, launches, busy share, ``gj_inv``'s
   launches and ms, GFLOP/s over the plan's flops, peak memory), a warm
   solve, the relative error <= 1e-10 and x, log|det| within 1e-9, then
   complex values on the same plan; BANDED on laplacian_2d_317 (AUTO: k
   320, nb 315, cyclic reduction) and the sequential scan on it (x's equal
   at 1e-10), and a complex128 run; SPLU on laplacian_3d_50 (the
   reference's SPLU size, BENCHMARKS.md §2) with
   ``splu_pairs``, ``gather_rows`` and ``gj_inv`` counted from 0 over the
   run; every path's second factorize-and-solve bit-identical; and the
   ``solve_matrix_market`` CLI in a subprocess on its default device (the
   card) on a MatrixMarket file of ``irregular_geometric(30_000)`` with
   ``--genie genmf``. ``gj_inv``'s entry on the kernels line gains its
   GENMF-264k launches and ms per factorization, and the SPLU kernels'
   their launches per factorization on laplacian_3d_50.

Every phase raises on failure, so the exit code is non-zero. The line
before the last is the kernels' JSON; the last is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py

To compare two trees on one card, unpack the other tree (``git
archive``) into an ignored directory and run ``python3 chip_smoke.py --ab
DIR [ROUNDS]``: the replay of phase 12 (with its device launches per
factorize pair), one GRIDMF factorize pair at npoint 129 and 513 (device
launches, device ms, profiled and median walls), the default path's cold
and warm walls at npoint 129 (median of three, with the spread) and the
npoint-513 ``bsr_matvec`` / ``bsr_matmat`` / ``spgemm`` times (back to
back, and the first call on a new matrix and after an in-place update of
its blocks, which builds the live layout) with DIR's package and with
this tree's, each in its own process, in turns P C C P, ROUNDS times,
then the medians, the ratios and the number of calls that pays for one
layout build. ``--replay [--tree DIR]`` is one such process.
``--lin-solver-path`` runs only phase 21 (after the device and build
phases). ``--chunk-sweep`` times ``splu_pairs`` over every row of the npoint-129
plan for each chunk size K of CHUNK_SWEEP, which is how
``splu.CHUNK_PAIRS`` was chosen; ``--strip-sweep`` times ``spgemm`` at
npoint 513 for each strip budget of STRIP_SWEEP, which is how
``kernels.SPGEMM_STRIP_BYTES`` was chosen; ``--base-sweep`` runs the
factorize pairs that reach ``gj_inv`` for each recursion base of
BASE_SWEEP, which is how ``splu.GJ_MAX_M`` was chosen.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if __name__ == "__main__" and "--tree" in sys.argv:
    # the A/B replay (--ab): this script run against another tree's package
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]))

import russell_tpu_torch  # noqa: E402  (fails at once outside the repo)

SEED = 129
NPOINT = 129
NPOINT_BSR = 513     # the reference's matched scale (bench.py:141-146)
ALPHA = 2e-3
REPS = 20
SPMM_M = 16
# the least time the card could take (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s, and 67 TFLOP/s FP64 on the tensor cores (34 TFLOP/s FP64 FMA
# outside them; the larger peak gives the smaller, safe bound)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS_PER_S = 67e12
# kernel against its plain version: the summation order differs
RTOL = 1e-12
# the replay's matrices: Radau5's real and complex shifts (radau5.f's
# GAMMA, ALPHA + i BETA) at h = 0.1, minus the Brusselator Jacobian at y0
H_REPLAY = 0.1
GAMMA = 3.6378342527444957 / H_REPLAY
ALPHA_BETA = complex(2.6810828736277521, 3.0504301992474105) / H_REPLAY
WARM_S = 1.0          # the card is kept busy this long before timing
CHUNK_SWEEP = (2, 4, 8, 16)
# spgemm_blocks' strip budgets in bytes (--strip-sweep)
STRIP_SWEEP = (16 << 10, 32 << 10, 64 << 10, 96 << 10)
# recursion bases of the pivot inverse (--base-sweep: splu.GJ_MAX_M)
BASE_SWEEP = (32, 64, 128, 136, 144)
# read before each call that cold_ms times: over twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flops over the f64 peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_flops = 1e3 * flops / F64_FLOPS_PER_S
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def reset_launch_counts():
    from russell_tpu_torch.sparse import kernels, splu
    splu.reset_launch_counts()
    kernels.reset_launch_counts()
    lanes = sys.modules.get("russell_tpu_torch.ode._lanes")
    if lanes is not None:
        lanes.lane_pow.launches = 0


def gj_inv_launches():
    """The gj_inv wrapper's launch count (0 in a tree without it, which
    --ab replays too)."""
    from russell_tpu_torch.sparse import splu
    return getattr(getattr(splu, "_gj_inv", None), "launches", 0)


def assert_close(name, got, want):
    """Hold ``got`` to ``want`` at rtol 1e-12, atol 1e-12 x max|want|;
    returns (max |got - want|, max |want|)."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want, device=got.device)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * scale,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()), scale


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps=REPS, warmup=3):
    """Device time of one call of ``fn`` in ms: ``reps`` calls back to back
    between two CUDA events, queued behind a sleep kernel long enough for
    the host to queue them all, so the device runs them without waiting on
    the host (the host's launch cost is not in the figure)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: a slower clock only lengthens the sleep
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=REPS, warmup=3):
    """Median device time of one call of ``fn`` in ms with a cold L2: a
    buffer of L2_FLUSH_BYTES is read before each call and two CUDA events
    bracket the call alone, all queued behind a sleep kernel as in
    ``time_ms``. The call's inputs then come from HBM, as the bounds
    assume."""
    flush = torch.ones(L2_FLUSH_BYTES // 8, dtype=torch.float64,
                       device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        flush.sum()
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def call_ms(fn, reps=REPS, warmup=3):
    """Median time of ``fn`` in ms with CUDA events around each call, one
    call at a time: the host's launch cost is included when it exceeds
    the kernel's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn):
    """Run ``fn`` once under torch.profiler (CUDA activity) and return
    ({kernel name: summed device ms} of every kernel it ran, the host wall
    of the run in s, the number of device events it ran: kernels, copies
    and fills)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out, launches = {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
            launches += e.count
    return out, wall, launches


def summed(ms_by_name, pattern):
    return sum(v for k, v in ms_by_name.items() if pattern in k)


def counters(st):
    return {k: getattr(st, k) for k in (
        "n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
        "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: "
                         "this smoke run needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from russell_tpu_torch.sparse import _cuda
    t0 = time.perf_counter()
    _cuda.build_all()
    wall = time.perf_counter() - t0
    for name in getattr(_cuda, "LIBRARIES", _cuda.KERNELS):
        _cuda.library(name)
        info = _cuda.build_info(name)
        say("build", kernel=name, all_wall_s=wall,
            nvcc_seconds=info.get("seconds"),
            ptxas=[ln.strip() for ln in info.get("log", "").splitlines()
                   if "registers" in ln or "spill" in ln or "smem" in ln])


def brusselator_plan(npoint):
    """The SolvePlan Radau5 builds for the Brusselator at ``npoint``."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system = samples.brusselator_pde(ALPHA, npoint)[0]
    ii, jj = system.jac_structure
    ndim = system.ndim
    rows = np.concatenate([ii, np.arange(ndim)])
    cols = np.concatenate([jj, np.arange(ndim)])
    return factor.analyze(ndim, rows, cols, genie=Genie.SPLU)


def replay_setup(npoint=NPOINT):
    """The plan and the real/complex values of one Radau5 factorize pair
    on the npoint Brusselator, through public functions only (the parent
    tree has them too, so --ab replays it with either package)."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    plan = factor.analyze(n, np.concatenate([ii, np.arange(n)]),
                          np.concatenate([jj, np.arange(n)]),
                          genie=Genie.SPLU)
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    dev = torch.device("cuda")
    vr = torch.as_tensor(np.concatenate([-jv, np.full(n, GAMMA)]),
                         device=dev)
    vc = torch.as_tensor(np.concatenate([-jv + 0j, np.full(n, ALPHA_BETA)]),
                         device=dev)
    return plan, vr, vc


def warm_up(setup):
    """Factorize pairs back to back for WARM_S seconds, at least one (it
    builds the kernels at first use); returns (pairs, wall s)."""
    from russell_tpu_torch.sparse import factor
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < WARM_S:
        factor.numeric_factorize_pair(*setup)
        torch.cuda.synchronize()
        n += 1
    return n, time.perf_counter() - t0


def replay(setup):
    """After ``warm_up``, one factorize pair under torch.profiler: each SPLU
    kernel's summed device time per factorize pair (gj_inv's 0 in a tree
    without it), all device time and device launches, and the host wall
    of the profiled pair."""
    from russell_tpu_torch.sparse import factor
    warm, warm_wall = warm_up(setup)
    ms, wall, launches = kernel_device_ms(
        lambda: factor.numeric_factorize_pair(*setup))
    return {"splu_pairs_ms": summed(ms, "splu_pairs"),
            "gather_rows_ms": summed(ms, "gather_rows"),
            "gj_inv_ms": summed(ms, "gj_inv"),
            "device_busy_ms": sum(ms.values()),
            "device_launches": launches,
            "profiled_wall_s": wall, "warm_pairs": warm,
            "warm_wall_s": warm_wall,
            "package": os.path.dirname(russell_tpu_torch.__file__)}


def pairs_bounds(pk, r, be, ln, npair, n_chunks):
    """splu_pairs' bound on row r at width be, on the live-lanes contract
    and on the earlier one that wrote all TL lanes: each distinct tile read
    once, the lanes written once, the index arrays the kernel reads;
    2 be^3 flops per pair. Returns ((ms, by), (ms, by))."""
    TL = pk["TL"]
    tiles = np.unique(np.concatenate([pk["pair_l"][r, :npair],
                                      pk["pair_u"][r, :npair]])).size
    flops = 2 * npair * be ** 3
    return (bound(8 * be * be * (tiles + ln) + 4 * (2 * npair + 2 * ln)
                  + 16 * n_chunks, flops),
            bound(8 * be * be * (tiles + TL) + 4 * (2 * npair + TL + 1),
                  flops))


def named_rows(sp, dp):
    """phase_kernels' rows: the most pairs, the most live lanes (len), the
    longest lane (pairs in series in the earlier design), the median len."""
    from russell_tpu_torch.sparse import splu
    TL = sp.packed["TL"]
    seg_ptr = splu._seg_ptr(sp.packed["pair_seg"], TL)
    lens = np.asarray([r[1] for r in dp["rows"]])
    npair = np.asarray([r[3] for r in dp["rows"]])
    longest = np.asarray([np.diff(seg_ptr[r, :lens[r] + 1]).max()
                          for r in range(len(lens))])
    return ({"argmax_pairs": int(npair.argmax()),
             "argmax_len": int(lens.argmax()),
             "longest_lane": int(longest.argmax()),
             "median_len": int(np.argsort(lens, kind="stable")[
                 len(lens) // 2])}, longest)


def phase_warmup():
    """Keep the card busy with factorize pairs for WARM_S before anything
    is timed (the clocks settle; first-use set-up is done)."""
    n, wall = warm_up(replay_setup())
    say("warmup", factorize_pairs=n, wall_s=wall)


def phase_kernels(plan):
    """Each SPLU kernel against its plain version at the shapes of four
    rows of the npoint-129 plan, with its device time (L2 warm and cold)
    beside its bounds, the plain version's and (gather_rows) the library
    call's (warm and cold); and the
    W-1024 and W-4096 timings in both orders by both timing methods.
    Returns the results."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    TL = pk["TL"]
    named, longest = named_rows(sp, dp)
    say("kernel_rows", K=splu.CHUNK_PAIRS, rows={
        name: {"row": r, "len": dp["rows"][r][1], "pairs": dp["rows"][r][3],
               "longest_lane": int(longest[r]), "chunks": dp["rows"][r][5],
               "multi_chunks": dp["rows"][r][6]}
        for name, r in named.items()})
    rng = np.random.default_rng(SEED)
    n_store = sp.nblk + TL + 1
    results = {}
    blocks_w = {}

    def row_args(blocks, r, be):
        n, ln = dp["rows"][r][3], dp["rows"][r][1]
        return (blocks, dp["pair_l"][r, :n], dp["pair_u"][r, :n],
                dp["pair_seg"][r, :n], dp["work"][r], ln, be)

    for be in (sp.b, 2 * sp.b):
        blocks = torch.as_tensor(
            rng.standard_normal((n_store, be * be)), device=dev)
        blocks_w[be] = blocks
        for name, r in named.items():
            args = row_args(blocks, r, be)
            ln, npair = args[5], args[1].numel()
            got = splu.splu_pairs(*args)
            again = splu.splu_pairs(*args)
            want = splu._splu_pairs_plain(*args[:4], ln, be)
            err, scale = assert_close(f"splu_pairs {name} be {be}", got, want)
            if not torch.equal(got, again):
                raise AssertionError(f"splu_pairs {name} be {be}: two "
                                     "launches differ")
            live, full = pairs_bounds(pk, r, be, ln, npair, dp["rows"][r][5])
            ms = time_ms(lambda: splu.splu_pairs(*args))
            cold = cold_ms(lambda: splu.splu_pairs(*args))
            plain_ms = time_ms(lambda: splu._splu_pairs_plain(*args[:4], ln,
                                                              be))
            say("kernel", name="splu_pairs", row_name=name, row=r, be=be,
                len=ln, pairs=npair, max_abs_err=err, scale=scale, rtol=RTOL,
                bit_identical=True, ms=ms, ms_cold_l2=cold, plain_ms=plain_ms,
                library_ms=None, bound_ms=live[0], bound_by=live[1],
                share=live[0] / ms, share_cold_l2=live[0] / cold,
                bound_tl_ms=full[0], bound_tl_by=full[1],
                share_tl=full[0] / ms)
            results[("splu_pairs", name, be)] = (
                err, ms, plain_ms, None, live[0], live[1], cold)

            idx = dp["dinv"][r, :ln]
            if not torch.equal(splu.gather_rows(blocks, idx),
                               splu._gather_rows_plain(blocks, idx)):
                raise AssertionError(f"gather_rows differs from blocks[idx] "
                                     f"at W={be * be}")
            ms = time_ms(lambda: splu.gather_rows(blocks, idx))
            cold = cold_ms(lambda: splu.gather_rows(blocks, idx))
            plain_ms = time_ms(lambda: splu._gather_rows_plain(blocks, idx))
            library_ms = time_ms(lambda: torch.index_select(blocks, 0, idx))
            library_cold = cold_ms(lambda: torch.index_select(blocks, 0, idx))
            b_ms, b_by = bound(8 * be * be * (torch.unique(idx).numel() + ln)
                               + 4 * ln, 0)
            say("kernel", name="gather_rows", row_name=name, row=r,
                rows=ln, W=be * be, max_abs_err=0.0, ms=ms, ms_cold_l2=cold,
                plain_ms=plain_ms, library_ms=library_ms,
                library_ms_cold_l2=library_cold, bound_ms=b_ms,
                bound_by=b_by, share=b_ms / ms, share_cold_l2=b_ms / cold,
                distinct_sources=int(torch.unique(idx).numel()))
            results[("gather_rows", name, be)] = (
                0.0, ms, plain_ms, library_ms, b_ms, b_by, cold)

    # the W-1024 / W-4096 timings in both orders, one call at a time (host
    # launch cost included) and back to back (device time)
    r = named["argmax_len"]
    for order in ((sp.b, 2 * sp.b), (2 * sp.b, sp.b)):
        rec = {}
        for be in order:
            blocks = blocks_w[be]
            idx = dp["dinv"][r, :dp["rows"][r][1]]
            args = row_args(blocks, r, be)
            fns = {"gather_rows": lambda: splu.gather_rows(blocks, idx),
                   "index_select": lambda: torch.index_select(blocks, 0,
                                                              idx),
                   "splu_pairs": lambda: splu.splu_pairs(*args)}
            rec[f"W{be * be}"] = {k: {"call_ms": call_ms(f),
                                      "ms": time_ms(f)}
                                  for k, f in fns.items()}
        say("order", row=r, widths=[be * be for be in order], **rec)
    del blocks_w, blocks
    torch.cuda.empty_cache()
    return results


def chunk_sweep(plan):
    """splu_pairs' device time over every row of the plan, b and 2b, under
    torch.profiler, for each chunk size K of CHUNK_SWEEP."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    rng = np.random.default_rng(SEED)
    blocks_w = {be: torch.as_tensor(rng.standard_normal(
        (sp.nblk + pk["TL"] + 1, be * be)), device=dev)
        for be in (sp.b, 2 * sp.b)}
    seg_ptr = splu._seg_ptr(pk["pair_seg"], pk["TL"])
    for K in CHUNK_SWEEP:
        works = []
        for r, row in enumerate(dp["rows"]):
            c, off, n_multi = splu._pair_chunks(seg_ptr[r], row[1], K)
            works.append(splu.PairWork(torch.as_tensor(c, device=dev),
                                       torch.as_tensor(off, device=dev),
                                       n_multi))
        rec = {}
        for be, blocks in blocks_w.items():
            def every_row():
                for r, row in enumerate(dp["rows"]):
                    n = row[3]
                    splu.splu_pairs(blocks, dp["pair_l"][r, :n],
                                    dp["pair_u"][r, :n],
                                    dp["pair_seg"][r, :n], works[r], row[1],
                                    be)
            every_row()
            rec[f"be{be}_ms"] = summed(kernel_device_ms(every_row)[0],
                                       "splu_pairs")
        say("chunk_sweep", K=K, chunks=sum(len(w.chunk) for w in works),
            **rec)


def phase_replay(plan):
    """phase_kernels' profiled part: one whole factorize pair (every row,
    both widths) under the profiler, beside the bound of the same work on
    both contracts. It runs after the main path, so that the profiler's
    tracing cannot reach the main path's wall."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dp = splu._device_plan(sp, torch.device("cuda"))
    rep = replay(replay_setup())
    bounds = {"live": 0.0, "tl": 0.0}
    for r, row in enumerate(dp["rows"]):
        for be in (sp.b, 2 * sp.b):
            live, full = pairs_bounds(pk, r, be, row[1], row[3], row[5])
            bounds["live"] += live[0]
            bounds["tl"] += full[0]
    g_bound = sum(bound(8 * be * be * (np.unique(pk["dinv"][r, :row[1]]).size
                                       + row[1]) + 4 * row[1], 0)[0]
                  for r, row in enumerate(dp["rows"])
                  for be in (sp.b, 2 * sp.b))
    say("replay", npoint=NPOINT, **rep,
        splu_pairs_bound_ms=bounds["live"],
        splu_pairs_bound_tl_ms=bounds["tl"],
        splu_pairs_share=bounds["live"] / rep["splu_pairs_ms"],
        splu_pairs_share_tl=bounds["tl"] / rep["splu_pairs_ms"],
        gather_rows_bound_ms=g_bound,
        gather_rows_share=g_bound / rep["gather_rows_ms"])
    return rep


def solve_radau5(system, y0, x1, params, dev):
    from russell_tpu_torch.ode import OdeSolver
    sol = OdeSolver(params, system, dev)
    y = sol.solve(y0, 0.0, x1)
    torch.cuda.synchronize()
    return sol, y


def phase_van_der_pol():
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, x0, y0, x1, _ = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.newton.genie = Genie.SPLU
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, x1, params, "cuda")
    wall = time.perf_counter() - t0
    st = sol.stats()
    got = counters(st)
    want = {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
            "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
            "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6}
    y = y.cpu().numpy()
    say("van_der_pol", wall_s=wall, counters=got, y=y.tolist(),
        h_accepted=st.h_accepted)
    if got != want:
        raise AssertionError(f"van der Pol counters {got} != radau5.f {want}")
    # tests/test_ode.py:57-68
    if (abs(y[0] - 1.706163410178079) >= 1e-12
            or abs(y[1] + 0.8927971289301175) >= 1e-11
            or abs(st.h_accepted - 0.1510987221365367) >= 1e-6):
        raise AssertionError("van der Pol y / h_accepted off the oracle")


def phase_brusselator_small():
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, _, y0, _ = samples.brusselator_pde(ALPHA, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.SPLU
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, 1.0, params, "cuda")
    wall = time.perf_counter() - t0
    got = counters(sol.stats())
    say("brusselator_16", wall_s=wall, counters=got,
        y_min=float(y.min()), y_max=float(y.max()))
    # the reference package's Radau5 + SPLU run on the CPU (f64)
    want = {"n_accepted": 25, "n_rejected": 1, "n_factor": 26,
            "n_lin_sol": 68, "n_jacobian": 22}
    if {k: got[k] for k in want} != want or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"npoint-16 Brusselator counters {got} != "
                             f"{want} (or y not finite)")


def phase_main_path(plan_rows):
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import splu
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = Genie.SPLU
    dev = torch.device("cuda")
    runs = {}
    for run in ("cold", "warm"):
        if run == "warm":  # a fresh solver; its host analysis is untimed
            sol = OdeSolver(params, system, dev)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_start = time.perf_counter()
        if run == "cold":  # the cold run includes the host analysis
            sol = OdeSolver(params, system, dev)
        y = sol.solve(y0, t0, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {"splu_pairs": splu.splu_pairs.launches,
                    "gather_rows": splu.gather_rows.launches,
                    "gj_inv": splu._gj_inv.launches}
        st = sol.stats()
        got = counters(st)
        runs[run] = {"wall_s": wall, "counters": got, "launches": launches,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "nanos_factor_max": st.nanos_factor_max,
                     "nanos_lin_sol_max": st.nanos_lin_sol_max}
        say("main_path", run=run, npoint=NPOINT, ndim=system.ndim,
            rows=plan_rows, **runs[run],
            y_shape=list(y.shape), y_min=float(y.min()),
            y_max=float(y.max()))
        if tuple(y.shape) != (system.ndim,) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("main path: y is not finite of shape "
                                 f"({system.ndim},)")
        need = got["n_factor"] * plan_rows
        for name in ("splu_pairs", "gather_rows"):
            if launches[name] < need:
                raise AssertionError(f"main path: {name} launched "
                                     f"{launches[name]} times, fewer than "
                                     f"n_factor x rows = {need}")
        if launches["gj_inv"] <= 0:
            raise AssertionError("main path: gj_inv was not launched")
        # the counters of PR 1-5's runs of this path
        want = {"n_function": 237, "n_jacobian": 21, "n_factor": 27,
                "n_lin_sol": 70, "n_steps": 27, "n_accepted": 25,
                "n_rejected": 1}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"main path counters {got} != {want}")
    return sol, y, runs


def phase_layers(sol, y):
    """Factorize pair, solve pair and one row's block inversion, timed on
    the npoint-129 matrix at the end state."""
    from russell_tpu_torch.sparse import factor, splu
    r5 = sol.actual
    h = sol.stats().h_accepted
    jv = r5._jac_fn(1.0, y, None)

    def fact():
        return r5._factorize(jv, h)

    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fr, fc = fact()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    factor_ms = call_ms(fact, reps=3, warmup=0)
    rng = np.random.default_rng(SEED)
    n = sol.ndim
    br = torch.as_tensor(rng.standard_normal(n), device=y.device)
    bc = torch.complex(br, torch.as_tensor(rng.standard_normal(n),
                                           device=y.device))
    solve_ms = call_ms(lambda: factor.factor_solve_pair(
        r5.plan, fr, fc, br, bc, refine_steps=0), reps=10)
    sp = r5.plan.splu_plan
    nd = max(r[2] for r in splu._device_plan(sp, y.device)["rows"])
    D = torch.as_tensor(rng.standard_normal((nd, 64, 64)), device=y.device)
    delta = torch.tensor(1e-14, dtype=torch.float64, device=y.device)
    inv32_ms = call_ms(lambda: splu._inv_block(D[:, :32, :32], delta))
    inv64_ms = call_ms(lambda: splu._inv_block(D, delta))
    say("layers", factorize_pair_wall_ms=[1e3 * w for w in walls],
        factorize_pair_device_ms=factor_ms, solve_pair_ms=solve_ms,
        inv_block_lanes=nd, inv_block_b32_ms=inv32_ms,
        inv_block_b64_ms=inv64_ms)


def inv_block_bases(m, w, out):
    """Append the (w, m) of each Gauss-Jordan base call that
    ``splu._inv_block`` makes on a (w, m, m) batch (its 2x2 Schur
    recursion down to m <= ``splu.GJ_MAX_M``)."""
    from russell_tpu_torch.sparse import splu
    if m <= splu.GJ_MAX_M:
        out.append((w, m))
        return
    h = m // 2
    inv_block_bases(h, w, out)
    inv_block_bases(m - h, w, out)


def gridmf_top_blocks(gplan):
    """{(w, m): calls} of ``splu._inv_block`` in one GRIDMF factorize pair:
    per depth the real plane's pivot blocks (e) and the complex one's K
    embedding (2e)."""
    return collections.Counter(
        blk for lv in gplan.levels
        for blk in ((lv.n_nodes, lv.e), (lv.n_nodes, 2 * lv.e)))


def splu_top_blocks(plan):
    """{(w, m): calls} of ``splu._inv_block`` in one SPLU factorize pair:
    per row with diagonal lanes, the real state's (nd, b) and the K
    state's (nd, 2b)."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    return collections.Counter(
        blk for row in splu._device_plan(sp, torch.device("cuda"))["rows"]
        if row[2] for blk in ((row[2], sp.b), (row[2], 2 * sp.b)))


def base_calls(top):
    """{(w, m): calls} of gj_inv under the top-level blocks ``top``."""
    calls = collections.Counter()
    for (w, m), c in top.items():
        out = []
        inv_block_bases(m, w, out)
        for blk in out:
            calls[blk] += c
    return calls


def gj_inputs(w, m, seed):
    """(w, m, m) f64 blocks made on the card from ``seed``, diagonally
    dominant, with exact zero pivots that the clamp must catch: lane 0 at
    step 0, and (w > 1) lane w // 2 at the last step (its last row and
    column zero)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = torch.randn((w, m, m), generator=g, dtype=torch.float64,
                    device="cuda")
    D.diagonal(dim1=1, dim2=2).add_(2.0 * m)
    D[0, 0, 0] = 0.0
    if w > 1:
        D[w // 2, -1, :] = 0.0
        D[w // 2, :, -1] = 0.0
    return D


def gj_work(w, m):
    """(bytes, flops) of the clamped inverse of a (w, m, m) batch: D read
    once, Dinv and the four per-lane statistics (three f64, one int32)
    written once; 2 m^3 flops a lane (m steps of an m x m rank-1 update),
    whichever base the recursion uses."""
    return 16 * w * m * m + 28 * w, 2 * m ** 3 * w


def gj_kernel_only(D, delta):
    """A launch of gj_inv's C entry point on D alone, outputs allocated
    once: the kernel's time without the wrapper's host work."""
    from russell_tpu_torch.sparse import _cuda
    w, m = D.shape[0], D.shape[-1]
    outs = [torch.empty_like(D)] + [
        torch.empty(w, dtype=t, device=D.device) for t in (
            torch.float64, torch.float64, torch.int32, torch.float64)]
    fn = _cuda.library("gj_inv").gj_inv_f64

    def launch():
        _cuda.launch_check("gj_inv", fn(
            D.data_ptr(), D.stride(0), D.stride(1), delta.data_ptr(), w, m,
            *(o.data_ptr() for o in outs), _cuda.stream_of(D)))
    return launch


def check_gj_inv(w, m, seed, delta):
    """gj_inv against its plain version at (w, m): Dinv bit-identical,
    min|pivot|, n_perturbed and the sign exact, log|det| at rtol 1e-14
    (both sum it in step order; the card's log and the CPU's may round
    apart), and the zero pivots clamped. Returns (max |Dinv - plain|,
    max relative log|det| error)."""
    from russell_tpu_torch.sparse import splu
    D = gj_inputs(w, m, seed)
    got = splu._gj_inv(D, delta)
    want = splu._gj_inv_plain(D, delta)
    err = float((got[0] - want[0]).abs().max())
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"gj_inv ({w}, {m}): Dinv differs from the "
                             f"plain version by up to {err}")
    ld_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0,
                               msg=lambda s: f"gj_inv ({w}, {m}) log|det|: "
                               f"{s}")
    for name, g, p in (("min|pivot|", got[2], want[2]),
                       ("n_perturbed", got[3], want[3]),
                       ("sign", got[4], want[4])):
        if not torch.equal(g, p):
            raise AssertionError(f"gj_inv ({w}, {m}): {name} differs from "
                                 "the plain version")
    npert = int(got[3].sum())
    if npert != (1 if w == 1 else 2) or float(got[2].min()) != 0.0:
        raise AssertionError(f"gj_inv ({w}, {m}): the zero pivots were not "
                             f"clamped ({npert} perturbed)")
    return err, ld_err


def check_gj_inv_shapes(tops):
    """``check_gj_inv`` at every (w, m) of the base calls under each plan's
    top-level blocks ``tops`` ({plan: {(w, m): calls}}), each shape once.
    Returns (max |Dinv - plain|, max relative log|det| error)."""
    from russell_tpu_torch.sparse import splu
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    max_err, ld_err, checked = 0.0, 0.0, set()
    for name, top in tops.items():
        calls = base_calls(top)
        for (w, m) in sorted(calls):
            if (w, m) in checked:
                continue
            checked.add((w, m))
            err, lde = check_gj_inv(w, m, w * 100 + m, delta)
            max_err, ld_err = max(max_err, err), max(ld_err, lde)
        say("gj_inv_shapes", plan=name, gj_max_m=splu.GJ_MAX_M,
            calls=sum(calls.values()),
            shapes=[[w, m, c] for (w, m), c in sorted(calls.items())])
    say("gj_inv_check", plans=list(tops), shapes=len(checked),
        max_abs_err=max_err, logdet_max_rel_err=ld_err, bit_identical=True)
    torch.cuda.empty_cache()
    return max_err, ld_err


def summed_times(calls, fn, reps=REPS, cold=False):
    """Sum over {(w, m): calls} of calls x the device time of ``fn(D)``
    on ``gj_inputs(w, m)`` (back to back, or L2-cold)."""
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    tot = 0.0
    for (w, m), c in sorted(calls.items()):
        D = gj_inputs(w, m, w + m)
        big = w * m * m > 1 << 24
        call = fn(D, delta)
        tot += c * (cold_ms if cold else time_ms)(
            call, reps=min(reps, 3) if big else reps,
            warmup=1 if big else 3)
        del D, call
    torch.cuda.empty_cache()
    return tot


def inv_block_pair(name, top):
    """One factorize pair's pivot inverses, ``top`` its {(w, m): calls} of
    ``splu._inv_block``: the gj_inv kernel's device time and launches
    (its base calls), _inv_block's whole device time and device launches
    (the kernel and the recursion's GEMMs, cats and adds), both against
    the bound of the top-level blocks (gj_work: 2 m^3 a lane, whatever
    the base) and against torch.linalg.inv_ex on the same top-level blocks
    (unclamped)."""
    from russell_tpu_torch.sparse import splu
    base = base_calls(top)
    nbytes = sum(c * gj_work(w, m)[0] for (w, m), c in top.items())
    flops = sum(c * gj_work(w, m)[1] for (w, m), c in top.items())
    b_ms, b_by = bound(nbytes, flops)
    ms = summed_times(base, lambda D, d: gj_kernel_only(D, d))
    inv_ms = summed_times(top, lambda D, d: (lambda: splu._inv_block(D, d)))
    lib_ms = summed_times(top, lambda D, d: (
        lambda: torch.linalg.inv_ex(D)))
    # device launches of the pair's _inv_block calls, in one profiled run
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    blocks = [(gj_inputs(w, m, w + m), c) for (w, m), c in top.items()]

    def all_calls():
        for D, c in blocks:
            for _ in range(c):
                splu._inv_block(D, delta)
    all_calls()
    n0 = gj_inv_launches()
    launches = kernel_device_ms(all_calls)[2]
    if gj_inv_launches() - n0 != sum(base.values()):
        raise AssertionError(f"{name}: gj_inv launched "
                             f"{gj_inv_launches() - n0} times for "
                             f"{sum(base.values())} base calls")
    del blocks
    torch.cuda.empty_cache()
    rec = {"pair": name, "top_blocks": sum(top.values()),
           "gj_inv_launches": sum(base.values()), "gj_inv_ms": ms,
           "inv_block_ms": inv_ms, "inv_block_launches": launches,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "inv_block_share": b_ms / inv_ms,
           "library_ms": lib_ms,
           "top_w_m_calls": [[w, m, c] for (w, m), c in sorted(top.items())],
           "base_w_m_calls": [[w, m, c]
                              for (w, m), c in sorted(base.items())]}
    say("inv_block_pair", **rec)
    return rec


def phase_gj_inv(splu_plan, gplans):
    """gj_inv against its plain version on the card at every (w, m) of its
    base calls in one npoint-129 SPLU factorize pair and in one GRIDMF
    factorize pair at npoint 129 and 513 (and 513 at leaf 16), with clamped
    lanes; then, per factorize pair (GRIDMF 129 and 513, SPLU 129), the
    kernel's and _inv_block's device time and launches beside the bound of
    the top-level blocks and torch.linalg.inv_ex on them
    (``inv_block_pair``); and, at the npoint-129 GRIDMF pair's base calls,
    the kernel's L2-cold time, its plain version's and inv_ex's on the same
    blocks, and the bound of that work. Returns the kernels line's
    numbers."""
    from russell_tpu_torch.sparse import splu
    delta = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    tops = {"splu_129": splu_top_blocks(splu_plan)}
    for key, gp in gplans.items():
        tops[f"gridmf_{key}"] = gridmf_top_blocks(gp)
    max_err, ld_err = check_gj_inv_shapes(tops)
    pairs = {name: inv_block_pair(name, tops[name]) for name in (
        "gridmf_129", "gridmf_513", "splu_129")}
    # the kernel alone at the npoint-129 GRIDMF pair's base calls
    base = base_calls(tops["gridmf_129"])
    nbytes = sum(c * gj_work(w, m)[0] for (w, m), c in base.items())
    flops = sum(c * gj_work(w, m)[1] for (w, m), c in base.items())
    b_ms, b_by = bound(nbytes, flops)
    res = {"max_abs_err": max_err, "ms": pairs["gridmf_129"]["gj_inv_ms"],
           "ms_cold_l2": summed_times(
               base, lambda D, d: gj_kernel_only(D, d), cold=True),
           "plain_ms": summed_times(base, lambda D, d: (
               lambda: splu._gj_inv_plain(D, d)), reps=3),
           "library_ms": summed_times(base, lambda D, d: (
               lambda: torch.linalg.inv_ex(D))),
           "bound_ms": b_ms, "bound_by": b_by}
    # one SPLU row's diagonal lanes: the real state (b) and the K state (2b)
    nd = max(w for (w, m) in tops["splu_129"])
    D = gj_inputs(nd, 64, 7)
    splu_row = {"lanes": nd,
                "b32_ms": time_ms(lambda: splu._gj_inv(D[:, :32, :32], delta)),
                "inv_block_2b64_ms": time_ms(lambda: splu._inv_block(D,
                                                                     delta))}
    say("gj_inv", per="npoint-129 GRIDMF factorize pair, its base calls",
        gj_max_m=splu.GJ_MAX_M, calls=sum(base.values()), bytes=nbytes,
        flops=flops, **res, share=b_ms / res["ms"],
        share_cold_l2=b_ms / res["ms_cold_l2"], splu_row=splu_row,
        logdet_max_rel_err=ld_err)
    torch.cuda.empty_cache()
    return {**res, "logdet_max_rel_err": ld_err,
            "inv_block": {k: {f: v[f] for f in (
                "gj_inv_launches", "gj_inv_ms", "inv_block_ms",
                "inv_block_launches", "bound_ms", "library_ms")}
                for k, v in pairs.items()}}


def brusselator_system(npoint):
    """The Brusselator at ``npoint``: (system, t0, y0, rows, cols) with
    Radau5's K pattern (Jacobian entries, then the mass diagonal)."""
    from russell_tpu_torch.ode import samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    return (system, t0, y0, np.concatenate([ii, np.arange(n)]),
            np.concatenate([jj, np.arange(n)]))


def gridmf_setup(npoint, leaf=None):
    """The GRIDMF plan that AUTO picks for the npoint Brusselator (or the
    one at ``leaf`` cells a leaf), with the replay's real and complex
    values on the card."""
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, rows, cols = brusselator_system(npoint)
    n = system.ndim
    leaves = factor.GRIDMF_LEAVES
    try:
        if leaf is not None:
            factor.GRIDMF_LEAVES = (leaf,)
        t_a = time.perf_counter()
        plan = factor.analyze(n, rows, cols, grid=system.grid)
        analyze_s = time.perf_counter() - t_a
    finally:
        factor.GRIDMF_LEAVES = leaves
    if plan.genie != Genie.GRIDMF:
        raise AssertionError(f"AUTO picked {plan.genie} at npoint {npoint}")
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    dev = torch.device("cuda")
    vr = torch.as_tensor(np.concatenate([-jv, np.full(n, GAMMA)]),
                         device=dev)
    vc = torch.as_tensor(np.concatenate([-jv + 0j, np.full(n, ALPHA_BETA)]),
                         device=dev)
    return plan, vr, vc, analyze_s


def gridmf_pair_flops(gplan):
    """Flops of one GRIDMF factorize pair: the real plane's
    (``gridmf_flops``) and the complex one's (the pivot inverse on the K
    embedding, 2 (2e)^3; panel and Schur products as 3 real products
    each)."""
    from russell_tpu_torch.sparse import gridmf
    cplx = sum(lv.n_nodes * (16 * lv.e ** 3 + 6 * lv.r * lv.e * lv.e
                             + 6 * lv.r * lv.r * lv.e)
               for lv in gplan.levels)
    return gridmf.gridmf_flops(gplan), gridmf.gridmf_flops(gplan) + cplx


def residual(plan, vals, x, b):
    """max |A x - b| / max |b| with A the entries ``vals`` at the plan's
    (rows, cols), on the card."""
    rows = torch.as_tensor(plan.rows, device=x.device)
    cols = torch.as_tensor(plan.cols, device=x.device)
    ax = torch.zeros(plan.n, dtype=x.dtype, device=x.device).index_add_(
        0, rows, vals * x[cols])
    return float((ax - b).abs().max() / b.abs().max())


def gridmf_pair_record(plan, vr, vc, pairs=3):
    """One GRIDMF factorize pair and one solve pair on the card, after a
    warm-up pair: wall (median of ``pairs``), device time and device
    launches per pair under the profiler, gj_inv launches per pair, peak
    memory, the residuals of both systems."""
    from russell_tpu_torch.sparse import factor, gridmf
    gp = plan.gridmf_plan
    rng = np.random.default_rng(SEED)
    n = plan.n
    br = torch.as_tensor(rng.standard_normal(n), device=vr.device)
    bc = torch.complex(br, torch.as_tensor(rng.standard_normal(n),
                                           device=vr.device))

    def fact():
        return factor.numeric_factorize_pair(plan, vr, vc)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr, fc = fact()
    torch.cuda.synchronize()
    walls = []
    for _ in range(pairs):
        del fr, fc
        t0 = time.perf_counter()
        fr, fc = fact()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    n0 = gj_inv_launches()
    fact()
    torch.cuda.synchronize()
    gj_per_pair = gj_inv_launches() - n0
    ms, prof_wall, launches = kernel_device_ms(fact)

    def solve():
        return factor.factor_solve_pair(plan, fr, fc, br, bc, refine_steps=0)

    xr, xc = solve()
    torch.cuda.synchronize()
    s_walls = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        s_walls.append(time.perf_counter() - t0)
    s_ms, _, s_launches = kernel_device_ms(solve)
    res = {"real": residual(plan, vr, xr, br),
           "complex": residual(plan, vc, xc, bc)}
    for k, v in res.items():
        if not v <= 1e-10:
            raise AssertionError(f"GRIDMF {k} residual {v} > 1e-10")
    real_flops, pair_flops = gridmf_pair_flops(gp)
    dev_ms = sum(ms.values())
    return {"leaf_e": gp.levels[-1].e, "depths": len(gp.levels),
            "factorize_pair_wall_ms": [1e3 * w for w in walls],
            "factorize_pair_wall_median_ms": 1e3 * statistics.median(walls),
            "factorize_pair_device_ms": dev_ms,
            "factorize_pair_device_busy_share": dev_ms / (1e3 * prof_wall),
            "factorize_pair_profiled_wall_ms": 1e3 * prof_wall,
            "factorize_pair_device_launches": launches,
            "gj_inv_launches_per_pair": gj_per_pair,
            "gj_inv_device_ms": summed(ms, "gj_inv"),
            "gemm_device_ms": sum(v for k, v in ms.items()
                                  if "gemm" in k.lower()),
            "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                   [:6]),
            "solve_pair_wall_median_ms": 1e3 * statistics.median(s_walls),
            "solve_pair_device_ms": sum(s_ms.values()),
            "solve_pair_device_launches": s_launches,
            "real_plane_flops": real_flops, "pair_flops": pair_flops,
            "pair_GFLOP_per_s_device": pair_flops / dev_ms / 1e6,
            "pair_GFLOP_per_s_wall": pair_flops / statistics.median(walls)
            / 1e9,
            "store_GB_per_plane": gridmf.gridmf_store_gb(gp, 8),
            "peak_mem_bytes": peak, "residual": res}


def phase_gridmf_small():
    """Radau5 through GRIDMF on the npoint-16 Brusselator: the reference
    package's counters (its GRIDMF run equals its BANDED one there,
    tests/test_ode.py:476)."""
    from russell_tpu_torch.ode import Method, Params, samples
    from russell_tpu_torch.sparse.enums import Genie
    system, _, y0, _ = samples.brusselator_pde(ALPHA, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.GRIDMF
    n0 = gj_inv_launches()
    t0 = time.perf_counter()
    sol, y = solve_radau5(system, y0, 1.0, params, "cuda")
    wall = time.perf_counter() - t0
    got = counters(sol.stats())
    say("gridmf_16", wall_s=wall, counters=got,
        gj_inv_launches=gj_inv_launches() - n0,
        y_min=float(y.min()), y_max=float(y.max()))
    want = {"n_accepted": 25, "n_rejected": 1, "n_factor": 26,
            "n_lin_sol": 68, "n_jacobian": 22}
    if sol.actual.plan.genie != Genie.GRIDMF or {
            k: got[k] for k in want} != want or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"npoint-16 GRIDMF counters {got} != {want} "
                             "(or y not finite, or not GRIDMF)")


def default_path_runs(warm_runs):
    """The reference's default path: Radau5 with default Params (genie
    AUTO) on the npoint-129 Brusselator, which AUTO routes to GRIDMF;
    tolerances 1e-4, t in [0, 1]. Yields a record, the solver and y of a
    cold run (host analysis included), then of ``warm_runs`` fresh solvers
    whose analysis is untimed, gj_inv's launches counted from 0 in each
    run."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    dev = torch.device("cuda")
    for i in range(1 + warm_runs):
        run = "cold" if i == 0 else "warm"
        if run == "warm":
            sol = OdeSolver(params, system, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_start = time.perf_counter()
        if run == "cold":
            sol = OdeSolver(params, system, dev)
        y = sol.solve(y0, t0, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = gj_inv_launches()
        st = sol.stats()
        got = counters(st)
        yield {"run": run, "wall_s": wall, "counters": got,
               "gj_inv_launches": launches,
               "gj_inv_launches_per_factorization": launches / max(
                   got["n_factor"], 1),
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "nanos_factor_max": st.nanos_factor_max,
               "nanos_lin_sol_max": st.nanos_lin_sol_max}, sol, y


def phase_gridmf_main_path(splu_counters, splu_y, warm_runs=3):
    """``default_path_runs`` checked: the plan is GRIDMF, y finite, gj_inv
    launched, and the counters held to the SPLU run's (or, where they
    differ, y to rtol 1e-6 of its y)."""
    from russell_tpu_torch.sparse.enums import Genie
    runs = []
    for rec, sol, y in default_path_runs(warm_runs):
        runs.append(rec)
        got, launches = rec["counters"], rec["gj_inv_launches"]
        say("gridmf_main_path", npoint=NPOINT, ndim=sol.ndim,
            genie=str(sol.actual.plan.genie), **rec,
            y_min=float(y.min()), y_max=float(y.max()))
        if sol.actual.plan.genie != Genie.GRIDMF:
            raise AssertionError("default Params did not route to GRIDMF")
        if tuple(y.shape) != (sol.ndim,) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("GRIDMF main path: y is not finite of "
                                 f"shape ({sol.ndim},)")
        if launches <= 0:
            raise AssertionError("GRIDMF main path: gj_inv was not launched")
        y_err = float(((y - splu_y).abs() / splu_y.abs()).max())
        if got != splu_counters:
            say("gridmf_vs_splu_counters", gridmf=got, splu=splu_counters,
                y_max_rel_err=y_err)
            if not y_err <= 1e-6:
                raise AssertionError(f"GRIDMF y differs from SPLU's by "
                                     f"{y_err} (rtol 1e-6)")
    warm = [r["wall_s"] for r in runs[1:]]
    say("gridmf_main_path_summary", npoint=NPOINT, cold_wall_s=runs[0][
        "wall_s"], warm_walls_s=warm, warm_median_s=statistics.median(warm),
        warm_spread_s=max(warm) - min(warm), counters=runs[-1]["counters"],
        splu_counters=splu_counters, counters_equal=runs[-1][
            "counters"] == splu_counters,
        y_max_rel_err_vs_splu=y_err, gj_inv_launches=runs[-1][
            "gj_inv_launches"])
    return runs, y.cpu()


def phase_gridmf_layers(leaves=(16, 32, 64)):
    """At npoint 129 and 513: one GRIDMF factorize pair and one solve pair
    (``gridmf_pair_record``) at the leaf AUTO picks, then the leaf sweep:
    the same at each leaf of ``leaves``. Returns the GRIDMF plans AUTO
    picked, by npoint, and the npoint-513 leaf-16 plan (its base calls
    reach 4,096 lanes) as "513_leaf16"."""
    plans = {}
    for npoint in (NPOINT, NPOINT_BSR):
        plan, vr, vc, analyze_s = gridmf_setup(npoint)
        plans[npoint] = plan.gridmf_plan
        rec = gridmf_pair_record(plan, vr, vc)
        say("gridmf_layers", npoint=npoint, ndim=plan.n,
            analyze_s=analyze_s, **rec)
        del plan, vr, vc
        torch.cuda.empty_cache()
        for leaf in leaves:
            plan, vr, vc, analyze_s = gridmf_setup(npoint, leaf)
            if npoint == NPOINT_BSR and leaf == 16:
                plans["513_leaf16"] = plan.gridmf_plan
            rec = gridmf_pair_record(plan, vr, vc, pairs=2)
            say("gridmf_leaf_sweep", npoint=npoint, leaf_cells=leaf,
                analyze_s=analyze_s, **{k: rec[k] for k in (
                    "leaf_e", "depths", "factorize_pair_wall_median_ms",
                    "factorize_pair_device_ms", "solve_pair_wall_median_ms",
                    "store_GB_per_plane", "peak_mem_bytes",
                    "pair_GFLOP_per_s_device", "residual")})
            del plan, vr, vc
            torch.cuda.empty_cache()
    return plans


def brusselator_jacobian(npoint):
    """J(y0) of the Brusselator at ``npoint`` as a host COO: the matrix
    whose BSR products the reference's yardstick names (BASELINE.json,
    "SpMV/SpMM nnz/s per chip"; bench.py:141-146 at npoint 513)."""
    from russell_tpu_torch.ode import samples
    from russell_tpu_torch.sparse import CooMatrix
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    ii, jj = system.jac_structure
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    return CooMatrix.from_arrays(system.ndim, system.ndim, ii, jj, jv)


def scipy_csr(coo):
    """The independent host answer: scipy's CSR of ``coo`` (duplicates
    summed)."""
    import scipy.sparse as sps
    ii, jj, vv = coo.triplets()
    return sps.csr_matrix((vv, (ii, jj)), shape=(coo.nrow, coo.ncol))


def torch_csr(a, dev):
    """scipy CSR ``a`` as a torch sparse CSR tensor on ``dev``, for the
    library yardsticks only (the port never calls them)."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr, dtype=torch.int64),
        torch.as_tensor(a.indices, dtype=torch.int64),
        torch.as_tensor(a.data), a.shape, device=dev)


def value_cost(t):
    """(bytes, flops of a product-add) of one value of ``t``'s dtype: 8
    and 2 for float64, 16 and 8 for complex128."""
    return t.element_size(), 8 if t.is_complex() else 2


def bsr_work(lay, m):
    """(bytes, flops) of the least work of Y = A X with X (n_cols, m), A
    given by its live layout ``lay``: each live nonzero read once (value,
    4-byte column; pads not counted), the row structure the kernels read
    (n_slices + 1 int64 slice offsets, 16x less than a CSR row pointer), X
    read and Y written once; a product-add per nonzero and column of X (2
    flops real, 8 complex)."""
    vb, fl = value_cost(lay.val)
    return ((vb + 4) * lay.nnz + 8 * (lay.n_slices + 1)
            + vb * m * (lay.n_rows + lay.n_cols), fl * lay.nnz * m)


def bsr_stored_work(bsr, m):
    """(bytes, flops) of Y = A X counted over every entry of the live
    blocks, zeros included, as a kernel that streams the stored blocks
    reads them: the bound such kernels were held to, kept for the
    record."""
    live = int((bsr.mask > 0).sum())
    return (8 * (live * bsr.bm * bsr.bn + (bsr.n_cols + bsr.n_rows) * m)
            + 12 * bsr.col_ids.numel(), 2 * live * bsr.bm * bsr.bn * m)


def first_call_s(fn):
    """Host seconds of ``fn``'s first call up to a synchronize: for
    bsr_matvec on a new matrix, the build of its live layout and one
    launch (~0.02 ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bit_identical(name, fn, first):
    """Raise unless two more launches of ``fn`` give ``first``'s bits."""
    for _ in range(2):
        if not torch.equal(fn(), first):
            raise AssertionError(f"{name}: two launches differ")


def spgemm_products(a, b):
    """Live scalar products of C = A B over the matrices' SpGEMM layouts
    (built by their first ``spgemm``): for each entry of A whose column k
    is a row of B, the entries of B's row k."""
    from russell_tpu_torch.sparse import kernels
    ra, rb = kernels._spgemm_layout(a), kernels._spgemm_layout(b)
    k = ra.col.long()
    return int(torch.diff(rb.row_ptr)[k[k < rb.n_rows]].sum())


def spgemm_work(plan, a, b):
    """(bytes, flops) of the least work of C = A B in the reference's output
    form: the live entries of each distinct operand once (value, 4-byte
    column) with its row structure (int64 row pointer), the C block columns
    (int32) and block-row pointer (int64), C written once (bm bn values a C
    block); a product-add per live scalar product (2 flops real, 8
    complex)."""
    from russell_tpu_torch.sparse import kernels
    lays = {id(m): kernels._spgemm_layout(m) for m in (a, b)}
    nbr = int(plan.c_block_ij[-1, 0]) + 1
    vb, fl = value_cost(a.blocks)
    return (sum((vb + 4) * lay.nnz + 8 * (lay.n_rows + 1)
                for lay in lays.values())
            + 4 * plan.c_blocks + 8 * (nbr + 1)
            + vb * a.bm * b.bn * plan.c_blocks, fl * spgemm_products(a, b))


def spgemm_stored_work(plan, a):
    """(bytes, flops) of A·A over ``plan`` counted over whole stored blocks,
    as a kernel of block products reads them: each distinct block the
    products use read once, the plan's index arrays, each C block written
    once; 2 bm bk bn flops per block product. The bound the earlier
    block-product kernel was held to, kept for the record."""
    n_ops = len(plan.a_idx)
    tiles = np.unique(np.concatenate([plan.a_idx, plan.b_idx])).size
    blk = a.bm * a.bn
    return (8 * blk * (tiles + plan.c_blocks)
            + 4 * (2 * n_ops + plan.c_blocks + 1),
            2 * n_ops * a.bm * a.bn * a.bn)


def spgemm_record(plan, a, first_s):
    """What the phases print of A·A beyond ``bsr_timings``: the stored-block
    bound, the live products and layout, the first call on the new matrix
    (layout build, plan upload and one launch; ``first_s``) and the first
    after an in-place update of its blocks, which rebuilds the layout."""
    from russell_tpu_torch.sparse import kernels
    lay = kernels._spgemm_layout(a)
    a.blocks.mul_(1.0)
    _, updated_s = first_call_s(lambda: kernels.spgemm(plan, a, a))
    return {"stored_bound_ms": bound(*spgemm_stored_work(plan, a))[0],
            "first_call_s": first_s, "updated_call_s": updated_s,
            "live_products": spgemm_products(a, a), "nnz_live": lay.nnz,
            "layout_bytes": lay.nbytes, "block_products": len(plan.a_idx),
            "c_blocks": plan.c_blocks,
            "strip": kernels._strip_chunks(a.bm, a.bn, kernels._device_plan(
                plan, a.blocks.device)["max_row_blocks"])}


def layout_record(lay, layout_s):
    """What the smoke prints of a matrix's live layout ``lay`` (built by
    its first bsr_matvec in ``layout_s`` s)."""
    return {"layout_s": layout_s, "nnz_live": lay.nnz,
            "slots": lay.val.numel(), "pad_share": lay.pad_share,
            "slices": lay.n_slices, "layout_bytes": lay.nbytes}


def library_or_none(lib):
    """``lib`` if one call of it runs on this card's PyTorch, else None
    (a yardstick only: a complex sparse product may not be implemented)."""
    try:
        lib()
        torch.cuda.synchronize()
        return lib
    except (RuntimeError, NotImplementedError) as exc:
        say("library_unavailable", error=str(exc)[:300])
        return None


def bsr_timings(kern, plain, lib, work, ms_warm=None):
    """The numbers of a BSR product that the kernels line takes: ``ms``,
    ``plain_ms`` and ``library_ms`` with the L2 flushed before each call
    (``cold_ms``; SpMV's whole working set at npoint 513 fits the 50 MB
    L2, so back-to-back calls would partly read it from there, not from
    HBM as the bound assumes), the kernel's and the library's back-to-back
    times (``time_ms``, L2 warm) beside them, and the bound of ``work``."""
    ms = cold_ms(kern)
    if ms_warm is None:
        ms_warm = time_ms(kern)
    plain_ms = cold_ms(plain)
    torch.cuda.empty_cache()
    b_ms, b_by = bound(*work)
    lib = library_or_none(lib)
    return {"ms": ms, "ms_warm_l2": ms_warm, "plain_ms": plain_ms,
            "library_ms": None if lib is None else cold_ms(lib),
            "library_ms_warm_l2": None if lib is None else time_ms(lib),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_bsr_kernels():
    """Each BSR kernel against its plain version on the npoint-129
    Jacobian, with the numbers of ``bsr_timings`` and, for SpMV / SpMM, the
    live layout's build time and pad share and the earlier stored-block
    bound (printed here; the kernels line takes ``bsr_path``'s)."""
    from russell_tpu_torch.sparse import kernels
    dev = torch.device("cuda")
    coo = brusselator_jacobian(NPOINT)
    a_csr = torch_csr(scipy_csr(coo), dev)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=dev)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, SPMM_M)), device=dev)
    bsr8 = kernels.bsr_from_coo(coo, 8, 128, dev)
    _, layout_s = first_call_s(lambda: kernels.bsr_matvec(bsr8, x))
    live = kernels._live_layout(bsr8)
    lay = layout_record(live, layout_s)
    bsr16 = kernels.bsr_from_coo(coo, 16, 16, dev)
    plan = kernels.spgemm_plan(bsr16, bsr16)
    _, spgemm_first_s = first_call_s(
        lambda: kernels.spgemm(plan, bsr16, bsr16))
    say("bsr_shapes", npoint=NPOINT, n=coo.nrow, coo_entries=coo.nnz,
        bsr8=[bsr8.nbr, bsr8.blocks_per_row, int((bsr8.mask > 0).sum())],
        bsr16=[bsr16.nbr, bsr16.blocks_per_row,
               int((bsr16.mask > 0).sum())],
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks, **lay)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (lambda: kernels.bsr_matvec(bsr8, x),
                     lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(live, 1),
                     bsr_stored_work(bsr8, 1)),
        "bsr_spmm": (lambda: kernels.bsr_matmat(bsr8, X),
                     lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(live, SPMM_M),
                     bsr_stored_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            lambda: kernels.spgemm(plan, bsr16, bsr16)[0],
            lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
            lambda: torch.sparse.mm(a_csr, a_csr),
            spgemm_work(plan, bsr16, bsr16), None),
    }
    for name, (kern, plain, lib, work, stored) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, scale = assert_close(name, got, want)
        bit_identical(name, kern, got)
        t = bsr_timings(kern, plain, lib, work)
        extra = ({"stored_bound_ms": bound(*stored)[0]} if stored else
                 spgemm_record(plan, bsr16, spgemm_first_s))
        say("bsr_kernel", name=name, npoint=NPOINT, scale=scale, rtol=RTOL,
            bytes=work[0], flops=work[1], max_abs_err=err, **t,
            share=t["bound_ms"] / t["ms"],
            share_warm_l2=t["bound_ms"] / t["ms_warm_l2"],
            bit_identical=True, **extra)
    torch.cuda.empty_cache()


def phase_bsr_path():
    """The BSR path through the public entry points on the npoint-513
    Jacobian. Each result is held against its kernel's plain version on
    the same inputs (every output entry, every C block) and against scipy
    on the host; the kernel, plain and library calls are timed at these
    shapes (``bsr_timings``)."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, kernels, spgemm,
                                          spgemm_plan)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    coo = brusselator_jacobian(NPOINT_BSR)
    a = scipy_csr(coo)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    x_h = rng.standard_normal(coo.ncol)
    X_h = rng.standard_normal((coo.ncol, SPMM_M))
    x = torch.as_tensor(x_h, device=dev)
    X = torch.as_tensor(X_h, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    t0 = time.perf_counter()
    bsr8 = bsr_from_coo(coo, 8, 128, dev)
    torch.cuda.synchronize()
    bsr8_s = time.perf_counter() - t0
    y, layout_s = first_call_s(lambda: bsr_matvec(bsr8, x))
    spmv_ms = time_ms(lambda: bsr_matvec(bsr8, x))
    Y = bsr_matmat(bsr8, X)
    spmm_ms = time_ms(lambda: bsr_matmat(bsr8, X))
    t0 = time.perf_counter()
    bsr16 = bsr_from_coo(coo, 16, 16, dev)
    torch.cuda.synchronize()
    bsr16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = spgemm_plan(bsr16, bsr16)
    plan_s = time.perf_counter() - t0
    (C, cij), spgemm_first_s = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    spgemm_ms = time_ms(lambda: spgemm(plan, bsr16, bsr16))
    torch.cuda.synchronize()
    launches = {"bsr_spmv": bsr_matvec.launches,
                "bsr_spmm": bsr_matmat.launches,
                "spgemm_blocks": spgemm.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"bsr_path: {name} was not launched")

    # each kernel against its plain version on the same inputs, in full;
    # two more launches give the same bits
    a_csr = torch_csr(a, dev)
    live = kernels._live_layout(bsr8)
    lay = layout_record(live, layout_s)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (y, spmv_ms, lambda: bsr_matvec(bsr8, x),
                     lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(live, 1),
                     bsr_stored_work(bsr8, 1)),
        "bsr_spmm": (Y, spmm_ms, lambda: bsr_matmat(bsr8, X),
                     lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(live, SPMM_M),
                     bsr_stored_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            C, spgemm_ms, lambda: spgemm(plan, bsr16, bsr16)[0],
            lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
            lambda: torch.sparse.mm(a_csr, a_csr),
            spgemm_work(plan, bsr16, bsr16), None),
    }
    # the kernels line takes ``results``: measured numbers and the bound;
    # the shares, the stored-block bound, the layouts and first calls go to
    # this phase's lines only
    results = {}
    for name, (got, ms_warm, kern, plain, lib, work,
               stored) in cases.items():
        want = plain()
        err, scale = assert_close(f"{name} vs plain", got, want)
        del want
        torch.cuda.empty_cache()
        bit_identical(name, kern, got)
        results[name] = {"max_abs_err": err,
                         **bsr_timings(kern, plain, lib, work, ms_warm)}
        t = results[name]
        extra = ({"stored_bound_ms": bound(*stored)[0],
                  "layout_s": layout_s, "pad_share": lay["pad_share"]}
                 if stored else spgemm_record(plan, bsr16, spgemm_first_s))
        say("bsr_path_kernel", name=name, npoint=NPOINT_BSR, scale=scale,
            rtol=RTOL, **t, share=t["bound_ms"] / t["ms"],
            share_warm_l2=t["bound_ms"] / t["ms_warm_l2"],
            bit_identical=True, **extra)
    del a_csr
    torch.cuda.empty_cache()

    # independent answers: scipy's CSR products on the host
    t0 = time.perf_counter()
    err_y, scale_y = assert_close("bsr_matvec vs scipy", y, a @ x_h)
    err_Y, scale_Y = assert_close("bsr_matmat vs scipy", Y, a @ X_h)
    a2 = (a @ a).tocsr()
    b = bsr16.bm
    n = coo.nrow
    sample = sorted({0, bsr16.nbr - 1,
                     *rng.choice(bsr16.nbr, 6, replace=False).tolist()})
    err_C = scale_C = 0.0
    for i in sample:
        lo, hi = np.searchsorted(cij[:, 0], [i, i + 1])
        r0, r1 = i * b, min((i + 1) * b, n)
        got = np.zeros((b, -(-n // b) * b))
        for q, blk in zip(cij[lo:hi, 1], C[lo:hi].cpu().numpy()):
            got[:, q * b:(q + 1) * b] = blk
        e, sc = assert_close(f"spgemm block row {i} vs scipy",
                             got[: r1 - r0, :n], a2[r0:r1].toarray())
        err_C, scale_C = max(err_C, e), max(scale_C, sc)
    check_s = time.perf_counter() - t0

    nnz = a.nnz
    metrics = {}
    for name, (nbytes, flops), per in (
            ("bsr_spmv", bsr_work(live, 1), nnz),
            ("bsr_spmm", bsr_work(live, SPMM_M), nnz),
            ("spgemm_blocks", spgemm_work(plan, bsr16, bsr16), None)):
        ms, b_ms = results[name]["ms"], results[name]["bound_ms"]
        metrics[name] = {
            "ms": ms, "launches": launches[name], "bytes": nbytes,
            "flops": flops, "GB_per_s": nbytes / ms / 1e6,
            "GFLOP_per_s": flops / ms / 1e6, "bound_ms": b_ms,
            "bound_by": results[name]["bound_by"],
            "roofline_share": b_ms / ms}
        if per is not None:
            metrics[name]["nnz_per_s"] = per / ms * 1e3
    metrics["bsr_spmm"]["nnz_rhs_per_s"] = (
        nnz * SPMM_M / results["bsr_spmm"]["ms"] * 1e3)
    metrics["spgemm_blocks"]["live_products_per_s"] = (
        spgemm_products(bsr16, bsr16) / results["spgemm_blocks"]["ms"] * 1e3)
    say("bsr_path", npoint=NPOINT_BSR, n=n, nnz=nnz, coo_entries=coo.nnz,
        jacobian_and_scipy_s=setup_s, bsr_from_coo_8x128_s=bsr8_s,
        bsr_from_coo_16x16_s=bsr16_s, spgemm_plan_s=plan_s,
        check_s=check_s,
        bsr8={"nbr": bsr8.nbr, "bpr": bsr8.blocks_per_row,
              "live_blocks": int((bsr8.mask > 0).sum()),
              "stored_GB": bsr8.blocks.numel() * 8 / 1e9, **lay},
        bsr16={"nbr": bsr16.nbr, "bpr": bsr16.blocks_per_row,
               "live_blocks": int((bsr16.mask > 0).sum())},
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks,
        C_GB=C.numel() * 8 / 1e9, spmm_m=SPMM_M,
        err_vs_scipy={"y": err_y, "y_scale": scale_y, "Y": err_Y,
                      "Y_scale": scale_Y, "C": err_C, "C_scale": scale_C,
                      "C_block_rows": sample},
        peak_mem_bytes=peak, **metrics)
    return launches, results


def complex_jacobian(npoint):
    """J(y0) + i 0.3 noise (seeded) as a host COO: a complex128 matrix of
    the Jacobian's pattern, as Radau5's (alpha + i beta) M - J is."""
    from russell_tpu_torch.sparse import CooMatrix
    coo = brusselator_jacobian(npoint)
    ii, jj, vv = (np.asarray(v) for v in coo.triplets())
    rng = np.random.default_rng(SEED + npoint)
    return CooMatrix.from_arrays(coo.nrow, coo.ncol, ii, jj,
                                 vv + 0.3j * rng.standard_normal(len(vv)))


def phase_bsr_complex():
    """The three BSR products on complex128 matrices (``complex_jacobian``
    at npoint 129 and 513) through the public entry points: each held to
    its plain version on the card (every entry) and to scipy on the host
    (y and Y in full, 8 block rows of C), launched twice more for bit
    identity, and timed L2-cold beside the bound and the library call
    (``bsr_timings``). Returns the npoint-513 numbers for the kernels
    line."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, kernels, spgemm,
                                          spgemm_plan)
    dev = torch.device("cuda")
    out = {}
    for npoint in (NPOINT, NPOINT_BSR):
        coo = complex_jacobian(npoint)
        a = scipy_csr(coo)
        rng = np.random.default_rng(SEED)
        x_h = rng.standard_normal(coo.ncol) + 1j * rng.standard_normal(
            coo.ncol)
        X_h = (rng.standard_normal((coo.ncol, SPMM_M))
               + 1j * rng.standard_normal((coo.ncol, SPMM_M)))
        x = torch.as_tensor(x_h, device=dev)
        X = torch.as_tensor(X_h, device=dev)
        reset_launch_counts()
        bsr8 = bsr_from_coo(coo, 8, 128, dev)
        y = bsr_matvec(bsr8, x)
        Y = bsr_matmat(bsr8, X)
        live = kernels._live_layout(bsr8)
        if live.val.dtype != torch.complex128:
            raise AssertionError("the live layout lost the complex values")
        a_csr = torch_csr(a, dev)
        results = {}
        for name, got, kern, plain, lib, work, want_h in (
                ("bsr_spmv", y, lambda: bsr_matvec(bsr8, x),
                 lambda: kernels._bsr_matvec_plain(bsr8, x),
                 lambda: a_csr @ x, bsr_work(live, 1), a @ x_h),
                ("bsr_spmm", Y, lambda: bsr_matmat(bsr8, X),
                 lambda: kernels._bsr_matmat_plain(bsr8, X),
                 lambda: a_csr @ X, bsr_work(live, SPMM_M), a @ X_h)):
            err, scale = assert_close(f"c128 {name} vs plain", got, plain())
            torch.cuda.empty_cache()
            err_s, _ = assert_close(f"c128 {name} vs scipy", got, want_h)
            bit_identical(f"c128 {name}", kern, got)
            results[name] = {"max_abs_err": err, "err_vs_scipy": err_s,
                             "scale": scale,
                             **bsr_timings(kern, plain, lib, work)}
        del bsr8, y, Y, live
        torch.cuda.empty_cache()
        bsr16 = bsr_from_coo(coo, 16, 16, dev)
        plan = spgemm_plan(bsr16, bsr16)
        C, cij = spgemm(plan, bsr16, bsr16)
        err, scale = assert_close("c128 spgemm vs plain", C,
                                  kernels._spgemm_plain(plan, bsr16, bsr16))
        torch.cuda.empty_cache()
        bit_identical("c128 spgemm", lambda: spgemm(plan, bsr16, bsr16)[0],
                      C)
        a2 = (a @ a).tocsr()
        b, n = bsr16.bm, coo.nrow
        err_s = 0.0
        for i in sorted({0, bsr16.nbr - 1, *rng.choice(
                bsr16.nbr, 6, replace=False).tolist()}):
            lo, hi = np.searchsorted(cij[:, 0], [i, i + 1])
            r0, r1 = i * b, min((i + 1) * b, n)
            got = np.zeros((b, -(-n // b) * b), np.complex128)
            for q, blk in zip(cij[lo:hi, 1], C[lo:hi].cpu().numpy()):
                got[:, q * b:(q + 1) * b] = blk
            err_s = max(err_s, assert_close(
                f"c128 spgemm block row {i} vs scipy", got[: r1 - r0, :n],
                a2[r0:r1].toarray())[0])
        del C
        results["spgemm_blocks"] = {
            "max_abs_err": err, "err_vs_scipy": err_s, "scale": scale,
            **bsr_timings(lambda: spgemm(plan, bsr16, bsr16)[0],
                          lambda: kernels._spgemm_plain(plan, bsr16, bsr16),
                          lambda: torch.sparse.mm(a_csr, a_csr),
                          spgemm_work(plan, bsr16, bsr16))}
        launches = {"bsr_spmv": bsr_matvec.launches,
                    "bsr_spmm": bsr_matmat.launches,
                    "spgemm_blocks": spgemm.launches}
        for name, t in results.items():
            say("bsr_complex", name=name, npoint=npoint, n=coo.nrow,
                nnz=a.nnz, dtype="complex128", rtol=RTOL, **t,
                share=t["bound_ms"] / t["ms"], launches=launches[name],
                bit_identical=True)
        out[npoint] = results
        del bsr16, plan, a_csr
        torch.cuda.empty_cache()
    return out[NPOINT_BSR]

# -- the ODE surface: samples, ERK, BwEuler and the DENSE route --------------

NPOINT_DENSE = 24     # ndim 1,152 <= dense_threshold: AUTO takes DENSE
ERK_WINDOW_X1 = 0.05  # the profiled window of the npoint-513 DoPri5 run
BWEULER_H = 0.01      # BwEuler's equal step (PERF.md §5: 0.1 diverges)


def ode_run(name, sample, method, x1=None, h_ini=None, tol=None,
            dense_h=None, h_equal=None, sample_args=(), y0=None, x0=None):
    """One OdeSolver run on the card with default Params apart from the
    named ones; returns (record, solver, y on the host, dense Output or
    None)."""
    from russell_tpu_torch.ode import Method, OdeSolver, Output, Params
    from russell_tpu_torch.ode import samples
    res = getattr(samples, sample)(*sample_args)
    system = res[0]
    x0 = res[1] if x0 is None else x0
    y0 = res[2] if y0 is None else y0
    if x1 is None:
        x1 = res[3]
    params = Params(Method[method])
    if h_ini is not None:
        params.step.h_ini = h_ini
    if tol is not None:
        params.set_tolerances(*tol)
    out = None
    if dense_h is not None:
        out = Output().set_dense_h_out(dense_h).set_dense_recording(
            list(range(system.ndim)))
    sol = OdeSolver(params, system, "cuda")
    t0 = time.perf_counter()
    y = sol.solve(y0, x0, x1, h_equal=h_equal, output=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sol.stats()
    rec = {"name": name, "method": method, "wall_s": wall,
           "counters": counters(st), "h_accepted": st.h_accepted,
           "y": y.cpu().tolist()}
    plan = getattr(sol.actual, "plan", None)
    if plan is not None:
        rec["genie"] = plan.genie.name
    return rec, sol, np.asarray(rec["y"]), out


def phase_ode_samples():
    """The Fortran oracles of tests/test_ode.py on the card, through the
    default genie AUTO (DENSE for these small systems): counters exact, y
    within the tolerances given there."""
    from russell_tpu_torch.ode import samples
    runs, bad = [], []

    def check(rec, want, y_want=(), h_want=None):
        """want: {counter: value}; y_want: [(index, value, tol)]."""
        got = {k: rec["counters"][k] for k in want}
        if got != want:
            bad.append(f"{rec['name']}: counters {got} != {want}")
        for i, v, tol in y_want:
            if not abs(rec["y"][i] - v) < tol:
                bad.append(f"{rec['name']}: y[{i}] {rec['y'][i]} off {v} "
                           f"by >= {tol}")
        if h_want is not None and not abs(rec["h_accepted"] - h_want[0]) \
                < h_want[1]:
            bad.append(f"{rec['name']}: h_accepted {rec['h_accepted']}")
        if rec.get("genie", "DENSE") != "DENSE":
            bad.append(f"{rec['name']}: genie {rec['genie']}, not DENSE")
        runs.append(rec)

    # Radau5 (tests/test_ode.py:47, :362, :34, :97)
    rec, *_ = ode_run("radau5_van_der_pol", "van_der_pol", "RADAU5",
                      h_ini=1e-6, dense_h=0.2, sample_args=(1e-6, False))
    check(rec, {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
                "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
                "n_rejected": 8, "n_iterations": 2, "n_iterations_max": 6},
          [(0, 1.706163410178079, 1e-12), (1, -8.927971289301175e-01,
                                           1e-11)],
          (1.510987221365367e-01, 1e-6))
    rec, *_ = ode_run("radau5_robertson", "robertson", "RADAU5", x1=0.3,
                      h_ini=1e-6, tol=(1e-8, 1e-2))
    check(rec, {"n_function": 88, "n_jacobian": 8, "n_factor": 15,
                "n_lin_sol": 24, "n_steps": 17, "n_accepted": 15,
                "n_rejected": 1},
          [(0, 9.886740138499884e-01, 1e-15), (1, 3.447720471782070e-05,
                                               1e-15),
           (2, 1.129150894529390e-02, 1e-15)], (8.160578540333708e-01,
                                                1e-10))
    y_fn = samples.hairer_wanner_eq1()[4]
    rec, *_ = ode_run("radau5_hairer_wanner", "hairer_wanner_eq1", "RADAU5",
                      x1=1.5, h_ini=1e-4)
    check(rec, {}, [(0, float(y_fn(1.5, None)[0]), 5e-5)])
    if not (rec["counters"]["n_accepted"] > 0
            and rec["counters"]["n_jacobian"] >= 1):
        bad.append("radau5_hairer_wanner: no accepted step or Jacobian")
    rec, *_ = ode_run("radau5_amplifier1t", "amplifier1t", "RADAU5", x1=0.05,
                      h_ini=1e-6, tol=(1e-4, 1e-4))
    check(rec, {"n_function": 1511, "n_jacobian": 126, "n_factor": 166,
                "n_lin_sol": 461, "n_steps": 166, "n_accepted": 127,
                "n_rejected": 6, "n_iterations_max": 5},
          [(0, -2.226517868073645e-02, 1e-10), (1, 3.068700099735197, 1e-10),
           (2, 2.898340496450958, 1e-9), (3, 2.033525366489690, 1e-7),
           (4, -2.269179823457655, 1e-7)], (7.791381954171996e-04, 1e-6))
    # DoPri5, DoPri8 (tests/test_ode.py:16, :321, :342)
    rec, _, _, out = ode_run("dopri5_hairer_wanner", "hairer_wanner_eq1",
                             "DOPRI5", x1=1.5, h_ini=1e-4, dense_h=0.1)
    check(rec, {"n_function": 235, "n_steps": 39, "n_accepted": 39,
                "n_rejected": 0}, [(0, 9.063921649310544e-02, 1e-13)])
    if len(out.dense_x()) != 16:
        bad.append("dopri5_hairer_wanner: not 16 dense stations")
    rec, *_ = ode_run("dopri5_arenstorf", "arenstorf", "DOPRI5", h_ini=1e-4,
                      tol=(1e-7, 1e-7))
    check(rec, {"n_function": 1429, "n_steps": 238, "n_accepted": 217,
                "n_rejected": 21},
          [(0, 9.940021704030663e-01, 1e-11), (1, 9.040891036151961e-06,
                                               1e-11),
           (2, 1.459758305600828e-03, 1e-9), (3, -2.001245515834718, 1e-9)],
          (5.258587607119909e-04, 1e-10))
    rec, *_ = ode_run("dopri8_van_der_pol", "van_der_pol", "DOPRI8", x1=2.0,
                      h_ini=1e-6, tol=(1e-9, 1e-9), dense_h=0.1,
                      sample_args=(1e-3, False), y0=np.array([2.0, 0.0]),
                      x0=0.0)
    check(rec, {"n_steps": 1469, "n_accepted": 1348, "n_rejected": 121,
                "n_function": 21553 - 2},
          [(0, 1.763234540172087, 1e-13), (1, -8.356886819301910e-01,
                                           1e-12)])
    # Euler (tests/test_ode.py:516, :529)
    rec, *_ = ode_run("bweuler_hairer_wanner", "hairer_wanner_eq1",
                      "BW_EULER", x1=1.5, h_equal=1.875 / 50.0)
    check(rec, {"n_function": 80, "n_jacobian": 40, "n_factor": 40,
                "n_lin_sol": 40, "n_steps": 40, "n_accepted": 40,
                "n_rejected": 0, "n_iterations_max": 2},
          [(0, 0.09060476604187756, 1e-15)])
    rec, *_ = ode_run("mdeuler_hairer_wanner", "hairer_wanner_eq1",
                      "MD_EULER", x1=1.5, h_ini=1e-4)
    check(rec, {"n_function": 424, "n_jacobian": 0, "n_factor": 0,
                "n_lin_sol": 0, "n_steps": 212, "n_accepted": 212,
                "n_rejected": 0}, [(0, 0.09062475637905158, 1e-16)])
    say("ode_samples", runs=[{k: v for k, v in r.items() if k != "y"}
                             | {"y": r["y"][:5]} for r in runs],
        failures=bad)
    if bad:
        raise AssertionError("ode_samples: " + "; ".join(bad))


def erk_brusselator(method, npoint, dev, x1=1.0, profile=False):
    """DoPri5 or DoPri8 on the npoint Brusselator (alpha ALPHA, tolerances
    1e-4, t in [0, x1]) with stiffness detection on (recorded, not raised)
    and dense stations every 0.1 handed to a callback; returns a record,
    y and the stations [(x, y on the host)]."""
    from russell_tpu_torch.ode import Method, OdeSolver, Output, Params
    from russell_tpu_torch.ode import samples
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, npoint)
    params = Params(Method[method])
    params.set_tolerances(1e-4, 1e-4)
    params.stiffness.enabled = True
    params.stiffness.stop_with_error = False
    params.stiffness.save_results = True
    stations = []

    def keep(stats, h, x, y, args):
        stations.append((x, y))
        return False

    out = Output().set_dense_h_out(0.1).set_dense_callback(keep)
    sol = OdeSolver(params, system, dev)
    rec = {"method": method, "npoint": npoint, "ndim": system.ndim,
           "device": str(dev), "x1": x1}
    if profile:
        ms, wall, launches = kernel_device_ms(
            lambda: sol.solve(y0, t0, x1, output=out))
        rec.update(profiled_wall_s=wall, device_ms=sum(ms.values()),
                   device_launches=launches)
        return rec, None, None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    y = sol.solve(y0, t0, x1, output=out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t_start
    st = sol.stats()
    rec.update(counters=counters(st), h_accepted=st.h_accepted,
               stiff_detected=len(out.stiff_x()) > 0,
               stiff_x=list(out.stiff_x()),
               stiff_step_index=list(out.stiff_step_index),
               stations=len(stations))
    return rec, y, stations


def phase_erk_path():
    """DoPri5 and DoPri8 on the npoint-129 Brusselator on the card and on
    the CPU in this run (counters exact, y and the dense stations at rtol
    1e-10), then DoPri5 on the npoint-513 Brusselator on the card (y
    finite); each with its wall, device launches per step and device busy
    share (the profiled run's device time over the unprofiled run's
    wall)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    out, y_out = [], {}
    for method, npoint, with_cpu in (("DOPRI5", NPOINT, True),
                                     ("DOPRI8", NPOINT, True),
                                     ("DOPRI5", NPOINT_BSR, False)):
        rec, y, stations = erk_brusselator(method, npoint, cuda)
        n_steps = rec["counters"]["n_steps"]
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"erk_path {method} {npoint}: y not finite")
        if npoint == NPOINT:
            prof, _, _ = erk_brusselator(method, npoint, cuda, profile=True)
            rec["launches_per_step"] = prof["device_launches"] / n_steps
            rec["device_busy_share"] = prof["device_ms"] / 1e3 / rec["wall_s"]
        else:
            # a window: the whole run's trace is ~10^6 events
            win, _, _ = erk_brusselator(method, npoint, cuda,
                                        x1=ERK_WINDOW_X1)
            prof, _, _ = erk_brusselator(method, npoint, cuda,
                                         x1=ERK_WINDOW_X1, profile=True)
            w_steps = win["counters"]["n_steps"]
            rec["window"] = {"x1": ERK_WINDOW_X1, "steps": w_steps,
                             "wall_s": win["wall_s"], **{
                                 k: prof[k] for k in (
                                     "profiled_wall_s", "device_ms",
                                     "device_launches")}}
            rec["launches_per_step"] = prof["device_launches"] / w_steps
            rec["device_busy_share"] = (prof["device_ms"] / 1e3
                                        / win["wall_s"])
            rec["wall_per_step_ms"] = 1e3 * rec["wall_s"] / n_steps
        if with_cpu:
            crec, cy, cstations = erk_brusselator(method, npoint, cpu)
            rec["cpu_wall_s"] = crec["wall_s"]
            rec["counters_equal_cpu"] = crec["counters"] == rec["counters"]
            rec["y_max_rel_err_vs_cpu"] = float(
                ((y.cpu() - cy).abs() / cy.abs()).max())
            say("erk_path", **rec)
            if crec["counters"] != rec["counters"]:
                raise AssertionError(f"erk_path {method}: counters "
                                     f"{rec['counters']} != the CPU's "
                                     f"{crec['counters']}")
            torch.testing.assert_close(y.cpu(), cy, rtol=1e-10, atol=0)
            if len(stations) != len(cstations):
                raise AssertionError("erk_path: station counts differ")
            for (x, ys), (cx, cys) in zip(stations, cstations):
                if x != cx:
                    raise AssertionError(f"erk_path: station x {x} != {cx}")
                np.testing.assert_allclose(ys, cys, rtol=1e-10, atol=0)
        else:
            say("erk_path", **rec)
        out.append(rec)
        y_out[(method, npoint)] = y.cpu()
        del y
        torch.cuda.empty_cache()
    return out, y_out


def phase_bweuler_path():
    """BwEuler on the npoint-129 Brusselator with default Params (AUTO →
    GRIDMF, so gj_inv runs) and equal steps of BWEULER_H: counters, wall,
    factorizations, gj_inv launches, y finite, and the last Newton solve's
    max|A x - b| / max|b| <= 1e-10."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    t_a = time.perf_counter()
    sol = OdeSolver(Params(Method.BW_EULER), system, "cuda")
    analyze_s = time.perf_counter() - t_a
    if sol.actual.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"BwEuler: AUTO picked {sol.actual.plan.genie}")
    last = {}
    solve = sol.actual._solve

    def solve_and_keep(r):
        last["b"], last["x"] = r, solve(r)
        return last["x"]

    sol.actual._solve = solve_and_keep
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    y = sol.solve(y0, t0, 1.0, h_equal=BWEULER_H)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = gj_inv_launches()
    r = factor._residual(sol.actual.plan, sol.actual._fac, last["x"],
                         last["b"])
    resid = float(r.abs().max() / last["b"].abs().max())
    st = sol.stats()
    say("bweuler_path", npoint=NPOINT, ndim=system.ndim, h_equal=BWEULER_H,
        genie=sol.actual.plan.genie.name, analyze_s=analyze_s, wall_s=wall,
        counters=counters(st), n_factor=st.n_factor,
        gj_inv_launches=launches, last_solve_residual=resid,
        nanos_factor_max=st.nanos_factor_max,
        nanos_lin_sol_max=st.nanos_lin_sol_max,
        y_min=float(y.min()), y_max=float(y.max()))
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("bweuler_path: y not finite")
    if launches <= 0:
        raise AssertionError("bweuler_path: gj_inv was not launched")
    if not resid <= 1e-10:
        raise AssertionError(f"bweuler_path: residual {resid} > 1e-10")


def phase_dense_factor():
    """Radau5 with default Params on the npoint-24 Brusselator (ndim 1,152,
    AUTO → DENSE with the grid hint) on the card and on the CPU in this run
    (counters exact, y at rtol 1e-10); then one factorize pair at the
    replay's shifts on both devices: residuals <= 1e-12 on the card,
    log|det|, min|pivot| and sign (phase) at rtol 1e-12 of the CPU's, and
    the pair's and a solve pair's device times."""
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
    from russell_tpu_torch.sparse import factor
    from russell_tpu_torch.sparse.enums import Genie
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT_DENSE)
    res = {}
    for dev in ("cuda", "cpu"):
        sol = OdeSolver(Params(Method.RADAU5), system, dev)
        if sol.actual.plan.genie != Genie.DENSE:
            raise AssertionError(f"npoint {NPOINT_DENSE}: AUTO picked "
                                 f"{sol.actual.plan.genie}")
        t_start = time.perf_counter()
        y = sol.solve(y0, t0, 1.0)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (time.perf_counter() - t_start, counters(sol.stats()),
                    y.cpu(), sol)
    (wall, got, y, sol), (cwall, cgot, cy, csol) = res["cuda"], res["cpu"]
    rec = {"npoint": NPOINT_DENSE, "ndim": system.ndim, "wall_s": wall,
           "cpu_wall_s": cwall, "counters": got,
           "y_max_rel_err_vs_cpu": float(((y - cy).abs() / cy.abs()).max())}
    if got != cgot:
        say("dense_factor", **rec, cpu_counters=cgot)
        raise AssertionError(f"dense_factor: counters {got} != CPU {cgot}")
    torch.testing.assert_close(y, cy, rtol=1e-10, atol=0)
    # one factorize pair at y0 with the replay's h
    jv = torch.as_tensor(system.jacobian(t0, torch.as_tensor(y0), None)
                         .numpy())
    facs = {}
    for dev, s in (("cuda", sol), ("cpu", csol)):
        facs[dev] = s.actual._factorize(jv.to(dev), H_REPLAY)
    plan = sol.actual.plan
    fr, fc = facs["cuda"]
    g = torch.Generator().manual_seed(SEED)
    br = torch.randn(system.ndim, generator=g, dtype=torch.float64)
    bc = torch.complex(torch.randn(system.ndim, generator=g,
                                   dtype=torch.float64),
                       torch.randn(system.ndim, generator=g,
                                   dtype=torch.float64))
    brd, bcd = br.cuda(), bc.cuda()
    xr, xc = factor.factor_solve_pair(plan, fr, fc, brd, bcd, refine_steps=0)
    stats = {}
    for kind, f, cf, x, b in (("real", fr, facs["cpu"][0], xr, brd),
                              ("complex", fc, facs["cpu"][1], xc, bcd)):
        r = factor._residual(plan, f, x, b)
        stats[kind] = {"residual": float(r.abs().max() / b.abs().max())}
        for k in ("logdet", "min_pivot", "phase"):
            got_v, want_v = f[k].cpu(), cf[k]
            stats[kind][k] = ([float(got_v.real), float(got_v.imag)]
                              if got_v.is_complex() else float(got_v))
            torch.testing.assert_close(got_v, want_v, rtol=1e-12, atol=0,
                                       msg=lambda m: f"dense {kind} {k}: {m}")
        if not stats[kind]["residual"] <= 1e-12:
            raise AssertionError(f"dense_factor: {kind} residual "
                                 f"{stats[kind]['residual']} > 1e-12")
    # per call, CUDA events around each: the host's launches included
    jvd = jv.cuda()
    rec.update(
        pair=stats, factorize_pair_ms=call_ms(
            lambda: sol.actual._factorize(jvd, H_REPLAY), reps=10),
        solve_pair_ms=call_ms(lambda: factor.factor_solve_pair(
            plan, fr, fc, brd, bcd, refine_steps=0), reps=10))
    say("dense_factor", **rec)


# ---------------------------------------------------------------------------
# fused_path: the whole integration on the card (solve(fused=True),
# solve_batch), a step attempt captured as one CUDA graph
# ---------------------------------------------------------------------------

FUSED_WARM_RUNS = 3
FUSED_BATCH = 64


def fused_kernel_counts():
    from russell_tpu_torch.ode import _lanes
    from russell_tpu_torch.sparse import splu
    return {"splu_pairs": splu.splu_pairs.launches,
            "gather_rows": splu.gather_rows.launches,
            "gj_inv": splu._gj_inv.launches,
            "lane_pow": _lanes.lane_pow.launches}


def loop_record(fn):
    """The captured graph of a fused solver ``fn`` and its last run."""
    lp = fn.loop
    return {"nodes_per_attempt": lp.nodes, "if_nodes": lp.if_nodes,
            "body_nodes": {str(k): v for k, v in lp.body_nodes.items()},
            "replays": lp.replays, "flag_reads": lp.reads,
            "replays_per_read": lp.replays // max(lp.reads, 1),
            "warmup_s": lp.warmup_s, "capture_instantiate_s": lp.capture_s}


def fused_runs(params, system, y0, t0, x1, warm_runs, output=None):
    """A cold fused run (a fresh solver: host analysis, uploads, warm-up,
    capture and instantiation, replays), then ``warm_runs`` more solves on
    the same solver, which replay the captured graph. The kernel counts
    start at 0 before the cold run: the warm-up's launches and the
    capture's nodes. Returns (record, solver, y of the last run)."""
    from russell_tpu_torch.ode import OdeSolver
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sol = OdeSolver(params, system, "cuda")
    y = sol.solve(y0, t0, x1, fused=True, output=output)
    torch.cuda.synchronize()
    rec = {"cold_wall_s": time.perf_counter() - t,
           "launches_cold_run": fused_kernel_counts(),
           "peak_mem_bytes_cold": torch.cuda.max_memory_allocated()}
    fn = next(iter(sol._fused.values()))
    rec.update(loop_record(fn))
    warm = []
    for _ in range(warm_runs):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        y = sol.solve(y0, t0, x1, fused=True, output=output)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    if warm:
        rec.update(warm_walls_s=warm, warm_median_s=statistics.median(warm),
                   warm_spread_s=max(warm) - min(warm),
                   peak_mem_bytes_warm=torch.cuda.max_memory_allocated(),
                   replays=fn.loop.replays, flag_reads=fn.loop.reads)
    rec["counters"] = counters(sol.stats())
    return rec, sol, y


def captured_nodes(sol, y0, t0, x1):
    """Each kernel's nodes in one captured step attempt: a fresh fused
    solver of ``sol``'s, warmed up, its counts reset, then captured."""
    fn = sol._build_fused(1)
    h0 = min(sol.params.step.h_ini, x1 - t0)
    fn.start(t0, torch.as_tensor(np.asarray(y0), device="cuda")[None], x1,
             h0)
    fn.loop.warm_up()
    reset_launch_counts()
    fn.loop.capture(warm_up=False)
    return fused_kernel_counts(), fn


LANE_POW_EXPONENTS = (0.17, 0.04, 0.25, 0.8, 3.0, -0.2)


def phase_lane_pow():
    """The fused controllers' pow (``csrc/lane_pow.cu``) against its plain
    version (the C library's pow, which the host path's Python floats
    use) on 10,000 bases per exponent of the controllers' kinds, beside
    CUDA's own pow; then its time at the fused path's shape (one lane) and
    at 64 lanes. Returns the kernels-line entry."""
    from russell_tpu_torch.ode import _lanes
    rng = np.random.default_rng(SEED)
    v = np.concatenate([rng.uniform(1e-3, 2.0, 5000),
                        10.0 ** rng.uniform(-10.0, 1.0, 5000)])
    t = torch.as_tensor(v, device="cuda")
    rows, worst = [], 0.0
    for e in LANE_POW_EXPONENTS:
        want = _lanes.lane_pow(torch.as_tensor(v), e).numpy()
        got = _lanes.lane_pow(t, e).cpu().numpy()
        cuda_pow = torch.pow(t, torch.full_like(t, e)).cpu().numpy()
        rel = float((np.abs(got - want) / np.abs(want)).max())
        worst = max(worst, float(np.abs(got - want).max()))
        rows.append({"e": e, "kernel_mismatches": int((got != want).sum()),
                     "cuda_pow_mismatches": int((cuda_pow != want).sum()),
                     "kernel_max_rel_err": rel})
    one = t[:1].clone()
    lanes = t[:FUSED_BATCH].clone()
    rec = {"name": "lane_pow", "route": "cuda",
           "source": "russell_tpu_torch/csrc/lane_pow.cu",
           "replaces": "russell_tpu/ode/radau5_fused.py:418 (plain XLA "
                       "pow of the fused controllers, no Pallas kernel; "
                       "also erk_fused.py:210)",
           "max_abs_err": worst,
           "ms": time_ms(lambda: _lanes.lane_pow(one, 0.25)),
           "ms_64_lanes": time_ms(lambda: _lanes.lane_pow(lanes, 0.25)),
           "plain_ms": time_ms(lambda: _lanes._lane_pow_plain(one, 0.25)),
           "library_ms": time_ms(lambda: torch.pow(one, 0.25))}
    # one value read and one written; ~600 f64 operations of the
    # double-double log and exp
    rec["bound_ms"], rec["bound_by"] = bound(16, 600)
    say("fused_path", part="lane_pow", values=len(v), exponents=rows,
        **{k: rec[k] for k in ("ms", "ms_64_lanes", "plain_ms",
                               "library_ms", "bound_ms")})
    for r in rows:
        if r["kernel_mismatches"] > len(v) // 500 or not r[
                "kernel_max_rel_err"] <= 2.3e-16:
            raise AssertionError(f"lane_pow: {r} (more than 0.2 % of the "
                                 "values off the C library's pow, or more "
                                 "than an ulp)")
    return rec


def check_counters(name, got, want):
    if got != want:
        raise AssertionError(f"fused_path {name}: counters {got} != the "
                             f"host-stepped run's {want}")


def fused_entry(fres, name):
    """A kernel's nodes per captured step attempt and its launches in the
    cold fused runs (warm-up launches plus capture nodes) of phase
    fused_path; the BSR kernels are on no fused path."""
    out = {}
    for part in ("gridmf_129", "splu_129", "gridmf_513"):
        rec = fres.get(part, {})
        if "nodes_per_kernel" in rec:
            out[f"{part}_nodes_per_attempt"] = rec["nodes_per_kernel"].get(
                name, 0)
        if "launches_cold_run" in rec:
            out[f"{part}_launches_cold_run"] = rec[
                "launches_cold_run"].get(name, 0)
        if "replays" in rec:
            out[f"{part}_replays"] = rec["replays"]
    return out


def phase_fused_path(gridmf_host, splu_host, erk_host):
    """The fused whole-integration loops on the card: radau5.f's oracles
    through DENSE, the bench.py configuration (GRIDMF at npoint 129) cold
    and warm with its graph, nodes, flag reads and device busy share,
    replay-count invariance, SPLU at 129, GRIDMF at 513, DoPri5 at 513 and
    DoPri8 with dense stations at 129, and solve_batch; each held to the
    host-stepped run of the same configuration in this smoke."""
    from russell_tpu_torch.ode import (Method, Output, Params, _device_loop,
                                       samples)
    from russell_tpu_torch.sparse.enums import Genie
    res = {"lane_pow": phase_lane_pow()}
    gc.collect()
    torch.cuda.empty_cache()

    # radau5.f oracles through DENSE (tests/test_ode.py:236, :384)
    system, x0, y0, x1, _ = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    rec, sol, y = fused_runs(params, system, y0, x0, x1, 0)
    y = y.cpu().numpy()
    want = {"n_function": 2249, "n_jacobian": 162, "n_factor": 253,
            "n_lin_sol": 668, "n_steps": 280, "n_accepted": 242,
            "n_rejected": 8, "n_iterations_max": 6}
    got = {k: rec["counters"][k] for k in want}
    say("fused_path", part="availability", torch=torch.__version__,
        cuda=torch.version.cuda,
        conditional_nodes_captured=rec["if_nodes"] > 0,
        replays_per_read=_device_loop.REPLAYS_PER_READ)
    say("fused_path", part="van_der_pol_dense",
        genie=sol.actual.plan.genie.name, y=y.tolist(), **rec)
    if (got != want or abs(y[0] - 1.706163410178079) >= 1e-12
            or abs(y[1] + 0.8927971289301175) >= 1e-11
            or sol.actual.plan.genie != Genie.DENSE or rec["if_nodes"] <= 0):
        raise AssertionError(f"fused van der Pol: {got} != radau5.f {want}"
                             " (or y off the oracle, or not DENSE)")
    system, x0, y0, _ = samples.robertson()
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.set_tolerances(1e-8, 1e-2)
    rec, sol, y = fused_runs(params, system, y0, x0, 0.3, 0)
    y = y.cpu().numpy()
    want = {"n_function": 88, "n_jacobian": 8, "n_factor": 15,
            "n_lin_sol": 24, "n_steps": 17, "n_accepted": 15,
            "n_rejected": 1}
    got = {k: rec["counters"][k] for k in want}
    say("fused_path", part="robertson_dense", y=y.tolist(), **rec)
    if got != want or any(abs(a - b) >= 1e-15 for a, b in zip(y, (
            9.886740138499884e-01, 3.447720471782070e-05,
            1.129150894529390e-02))):
        raise AssertionError(f"fused Robertson: {got} != radau5.f {want} "
                             "(or y off the oracle)")

    # the bench.py configuration: default Params (AUTO -> GRIDMF), npoint
    # 129, tolerances 1e-4, t 0 -> 1
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, FUSED_WARM_RUNS)
    check_counters("gridmf_129", rec["counters"], gridmf_host["counters"])
    y_err = float((y.cpu() - gridmf_host["y"]).abs().max())
    if not y_err <= 1e-12 or sol.actual.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"fused GRIDMF 129: y off the host-stepped "
                             f"run's by {y_err} (atol 1e-12), or not GRIDMF")
    if rec["launches_cold_run"]["gj_inv"] <= 0:
        raise AssertionError("fused GRIDMF 129: gj_inv was not launched")
    ms, p_wall, events = kernel_device_ms(
        lambda: sol.solve(y0, t0, 1.0, fused=True))
    rec.update(device_ms=sum(ms.values()), device_events=events,
               profiled_wall_s=p_wall,
               device_busy_share=sum(ms.values()) / 1e3 / rec[
                   "warm_median_s"],
               gj_inv_device_ms=summed(ms, "gj_inv"),
               host_stepped_warm_median_s=gridmf_host["warm_median_s"],
               host_stepped_counters=gridmf_host["counters"],
               y_max_abs_err_vs_host=y_err)
    y8 = y.clone()
    c8 = counters(sol.stats())
    # replay-count invariance: one replay per flag read gives the same bits
    nodes, fn = captured_nodes(sol, y0, t0, 1.0)
    default = _device_loop.REPLAYS_PER_READ
    try:
        _device_loop.REPLAYS_PER_READ = 1
        fn.loop.run()
    finally:
        _device_loop.REPLAYS_PER_READ = default
    y1, st1 = fn.result()
    c1 = {k: int(st1[k][0]) if k in st1 else c8[k] for k in c8}
    same = bool(torch.equal(y1[0], y8)) and c1 == c8
    rec.update(nodes_per_kernel=nodes, replay_invariance={
        "replays_per_read": 1, "reads": fn.loop.reads,
        "bit_identical": same})
    say("fused_path", part="gridmf_129", npoint=NPOINT, **rec)
    if not same:
        raise AssertionError("fused GRIDMF 129: one replay per flag read "
                             "changes y or the counters")
    res["gridmf_129"] = rec
    del sol, fn, y, y1, y8
    gc.collect()
    torch.cuda.empty_cache()

    # SPLU at npoint 129
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    params.newton.genie = Genie.SPLU
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1)
    check_counters("splu_129", rec["counters"], splu_host["counters"])
    y_err = float((y.cpu() - splu_host["y"]).abs().max())
    nodes, fn = captured_nodes(sol, y0, t0, 1.0)
    rec.update(nodes_per_kernel=nodes, y_max_abs_err_vs_host=y_err,
               host_stepped_warm_wall_s=splu_host["wall_s"])
    say("fused_path", part="splu_129", npoint=NPOINT, **rec)
    if not y_err == 0.0:
        raise AssertionError(f"fused SPLU 129: y off the host-stepped run's"
                             f" by {y_err} (the ordered sums give the same "
                             "bits)")
    for k in ("splu_pairs", "gather_rows", "gj_inv"):
        if rec["launches_cold_run"][k] <= 0 or nodes[k] <= 0:
            raise AssertionError(f"fused SPLU 129: {k} was not launched")
    res["splu_129"] = rec
    del sol, fn, y
    gc.collect()
    torch.cuda.empty_cache()

    # GRIDMF at npoint 513 (bench.py's top rung): host-stepped, then fused
    from russell_tpu_torch.ode import OdeSolver
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT_BSR)
    params = Params(Method.RADAU5)
    params.set_tolerances(1e-4, 1e-4)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    host = OdeSolver(params, system, "cuda")
    yh = host.solve(y0, t0, 1.0)
    torch.cuda.synchronize()
    host_rec = {"wall_s": time.perf_counter() - t,
                "counters": counters(host.stats()),
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    yh = yh.cpu()
    del host
    gc.collect()
    torch.cuda.empty_cache()
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1)
    check_counters("gridmf_513", rec["counters"], host_rec["counters"])
    y_err = float((y.cpu() - yh).abs().max())
    gplan = sol.actual.plan.gridmf_plan
    rec.update(host_stepped=host_rec, y_max_abs_err_vs_host=y_err,
               depths=len(gplan.levels), leaf_front_e=gplan.levels[-1].e)
    say("fused_path", part="gridmf_513", npoint=NPOINT_BSR, **rec)
    if not y_err <= 1e-10:
        raise AssertionError(f"fused GRIDMF 513: y off the host-stepped "
                             f"run's by {y_err} (atol 1e-10)")
    res["gridmf_513"] = rec
    del sol, y, yh
    gc.collect()
    torch.cuda.empty_cache()

    # DoPri5 at npoint 513 against erk_path's host-stepped run (its
    # stiffness detection changes no step), with the same dense stations
    params = Params(Method.DOPRI5)
    params.set_tolerances(1e-4, 1e-4)
    stations = []

    def keep(stats, h, x, yy, args):
        stations.append(x)
        return False

    out = Output().set_dense_h_out(0.1).set_dense_callback(keep)
    rec, sol, y = fused_runs(params, system, y0, t0, 1.0, 1, output=out)
    host = erk_host[("DOPRI5", NPOINT_BSR)]
    check_counters("dopri5_513", rec["counters"], host["counters"])
    y_err = float(((y.cpu() - host["y"]).abs() / host["y"].abs()).max())
    win = sol.solve(y0, t0, ERK_WINDOW_X1, fused=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sol.solve(y0, t0, ERK_WINDOW_X1, fused=True)
    torch.cuda.synchronize()
    w_wall = time.perf_counter() - t
    w_steps = sol.stats().n_steps
    ms, p_wall, events = kernel_device_ms(
        lambda: sol.solve(y0, t0, ERK_WINDOW_X1, fused=True))
    rec.update(y_max_rel_err_vs_host=y_err, host_stepped_wall_s=host[
        "wall_s"], stations=len(out.dense_x()), window={
            "x1": ERK_WINDOW_X1, "steps": w_steps, "wall_s": w_wall,
            "device_ms": sum(ms.values()), "device_events": events,
            "profiled_wall_s": p_wall,
            "device_busy_share": sum(ms.values()) / 1e3 / w_wall})
    say("fused_path", part="dopri5_513", npoint=NPOINT_BSR, **rec)
    if not y_err <= 1e-10:
        raise AssertionError(f"fused DoPri5 513: y off the host-stepped "
                             f"run's by {y_err} (rtol 1e-10)")
    res["dopri5_513"] = rec
    del sol, y, win
    gc.collect()
    torch.cuda.empty_cache()

    # DoPri8 at npoint 129 with dense stations every 0.1, held to a
    # host-stepped run of the same parameters
    system, t0, y0, _ = samples.brusselator_pde(ALPHA, NPOINT)
    params = Params(Method.DOPRI8)
    params.set_tolerances(1e-4, 1e-4)
    outs = {}
    for fused in (False, True):
        o = Output().set_dense_h_out(0.1).set_dense_recording(
            list(range(0, system.ndim, 997)))
        s8 = OdeSolver(params, system, "cuda")
        t = time.perf_counter()
        s8.solve(y0, t0, 1.0, output=o, fused=fused)
        torch.cuda.synchronize()
        outs[fused] = (o, time.perf_counter() - t, counters(s8.stats()))
    err = max(float(np.abs(np.asarray(outs[True][0].dense_y(m))
                           - np.asarray(outs[False][0].dense_y(m))).max())
              for m in range(0, system.ndim, 997))
    say("fused_path", part="dopri8_129_dense", npoint=NPOINT,
        stations=len(outs[True][0].dense_x()), station_max_abs_err=err,
        fused_cold_wall_s=outs[True][1], host_wall_s=outs[False][1],
        counters=outs[True][2])
    check_counters("dopri8_129", outs[True][2], outs[False][2])
    if not err <= 1e-10 or outs[True][0].dense_x() != outs[False][
            0].dense_x():
        raise AssertionError(f"fused DoPri8 129: stations off the host's by"
                             f" {err} (atol 1e-10)")

    # solve_batch: each lane held to its single fused solve
    for name, make in (("van_der_pol", "RADAU5"), ("hairer_wanner", "DOPRI5")):
        if name == "van_der_pol":
            system, x0, y0, _, _ = samples.van_der_pol(1e-4, False)
            y0s = np.tile(np.asarray(y0)[None, :], (FUSED_BATCH, 1))
            y0s[:, 0] += np.linspace(-0.2, 0.2, FUSED_BATCH)
            x1, params = 1.0, Params(Method.RADAU5)
        else:
            system, x0, y0, _, _ = samples.hairer_wanner_eq1()
            y0s = np.linspace(0.5, 2.0, FUSED_BATCH)[:, None] * np.asarray(
                y0)[None, :]
            y0s[:, 0] += np.linspace(0.0, 0.7, FUSED_BATCH)
            x1, params = 1.5, Params(Method.DOPRI5)
            params.step.h_ini = 1e-4
        bsol = OdeSolver(params, system, "cuda")
        walls = []
        for _ in range(2):
            t = time.perf_counter()
            ys, st = bsol.solve_batch(y0s, x0, x1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        keys = [k for k in counters(bsol.stats()) if k in st]
        worst, bad = 0.0, []
        t = time.perf_counter()
        for b in range(FUSED_BATCH):
            yb = bsol.solve(y0s[b], x0, x1, fused=True)
            worst = max(worst, float((yb - ys[b]).abs().max()))
            single = counters(bsol.stats())
            if any(int(st[k][b]) != single[k] for k in keys):
                bad.append(b)
        torch.cuda.synchronize()
        singles = time.perf_counter() - t
        say("fused_path", part=f"solve_batch_{name}", method=make,
            lanes=FUSED_BATCH, cold_wall_s=walls[0], warm_wall_s=walls[1],
            singles_wall_s=singles, statuses=sorted(set(
                st["status"].tolist())),
            n_accepted_range=[int(st["n_accepted"].min()),
                              int(st["n_accepted"].max())],
            lane_max_abs_err=worst, lanes_with_other_counters=bad,
            genie=(bsol.actual.plan.genie.name if make == "RADAU5"
                   else None))
        if (st["status"].tolist() != [1] * FUSED_BATCH or bad
                or not worst <= 1e-12):
            raise AssertionError(f"solve_batch {name}: lanes {bad} differ "
                                 f"from single solves (y by {worst})")
    return res


# -- lin_solver_path ---------------------------------------------------------

GEOMETRIC_N = 263_743   # geometric_264k (BENCHMARKS.md §2)
LAPLACIAN_2D_NPOINT = 317
LAPLACIAN_3D_NPOINT = 50  # laplacian_3d_50, the reference's SPLU size
CLI_N = 30_000
LS_WARM_RUNS = 3
# the LinSolver path against SciPy's SuperLU: x and log|det|
LS_RTOL = {"genmf": 1e-9, "banded": 1e-10, "splu": 1e-10}


def perm_sign(p):
    """The sign of the permutation ``p``: (-1)^(n - number of cycles)."""
    p = np.asarray(p)
    seen = np.zeros(len(p), dtype=bool)
    cycles = 0
    for i in range(len(p)):
        if not seen[i]:
            cycles += 1
            j = i
            while not seen[j]:
                seen[j] = True
                j = p[j]
    return -1.0 if (len(p) - cycles) % 2 else 1.0


def superlu_oracle(coo, vals, bs):
    """SciPy's SuperLU on the host, independent of the port's numerics:
    x for each right-hand side of ``bs``, log|det| and the determinant's
    phase (sign for a real matrix). The matrix is symmetrically permuted
    by nested dissection first (``ordering.nd_ordering``; SuperLU's own
    MMD and COLAMD orderings take minutes at n 264k) and SuperLU keeps
    that column order, pivoting rows as it needs."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from russell_tpu_torch.sparse.ordering import nd_ordering
    t0 = time.perf_counter()
    ii, jj, _ = coo.triplets()
    n = coo.nrow
    p = nd_ordering(n, ii, jj)
    ip = np.empty(n, dtype=np.int64)
    ip[p] = np.arange(n)
    a = sp.csc_matrix((vals, (ip[ii], ip[jj])), shape=(n, n))
    lu = spla.splu(a, permc_spec="NATURAL",
                   options={"SymmetricMode": True})
    xs = []
    for b in bs:
        y = lu.solve(np.asarray(b)[p])
        x = np.empty_like(y)
        x[p] = y
        xs.append(x)
    d = lu.U.diagonal()
    ad = np.abs(d)
    phase = complex(np.prod(d / ad)) * perm_sign(lu.perm_r) * perm_sign(
        lu.perm_c)
    return xs, float(np.sum(np.log(ad))), phase, time.perf_counter() - t0


def det_log_phase(m, e):
    """(log|det|, phase) of a LinSolver determinant (mantissa, 10, e)."""
    return (np.log(abs(m)) + e * np.log(10.0)), complex(m) / abs(m)


def fac_log_phase(plan, fac):
    """(log|det|, phase) of the unscaled matrix from factor's factors."""
    from russell_tpu_torch.sparse import factor
    log_scale = float(torch.log(fac["rs"]).sum() + torch.log(fac["cs"]).sum())
    return (float(fac["logdet"]) - log_scale,
            complex(factor.det_phase(plan, fac)))


def check_oracle(name, x, logdet, phase, ox, ologdet, ophase, rtol):
    """Hold x, log|det| and the phase to SuperLU's at ``rtol``; returns
    the errors."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    x_err = float(np.abs(x - ox).max() / np.abs(ox).max())
    ld_err = abs(logdet - ologdet) / abs(ologdet)
    ph_err = abs(phase - ophase)
    if not (x_err <= rtol and ld_err <= rtol and ph_err <= rtol):
        raise AssertionError(
            f"{name}: off SuperLU's (rtol {rtol}): x {x_err}, log|det| "
            f"{ld_err}, phase {phase} vs {ophase}")
    return {"x_rel_err_vs_superlu": x_err,
            "logdet_rel_err_vs_superlu": ld_err,
            "phase_err_vs_superlu": ph_err}


def timed_factorizations(fact, warm=LS_WARM_RUNS):
    """``fact()`` (which waits for its result) ``warm`` times after a cold
    call made by the caller: the walls, then one more under the profiler
    (device ms, device launches, busy share, gj_inv's launches and ms) and
    the peak memory of them all."""
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fact()
        walls.append(time.perf_counter() - t0)
    n0 = gj_inv_launches()
    ms, p_wall, launches = kernel_device_ms(fact)
    dev_ms = sum(ms.values())
    return {"warm_wall_s": walls,
            "warm_median_s": statistics.median(walls),
            "warm_spread_s": max(walls) - min(walls),
            "device_ms": dev_ms, "device_launches": launches,
            "profiled_wall_s": p_wall,
            "device_busy_share": dev_ms / (1e3 * p_wall),
            "gj_inv_launches": gj_inv_launches() - n0,
            "gj_inv_device_ms": summed(ms, "gj_inv"),
            "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                   [:5])}


def timed_solves(solve, reps=3):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def kernel_counts():
    from russell_tpu_torch.sparse import splu
    return {"splu_pairs": splu.splu_pairs.launches,
            "gather_rows": splu.gather_rows.launches,
            "gj_inv": gj_inv_launches()}


@contextlib.contextmanager
def held_to_plain():
    """Within the block, every launch of gj_inv, splu_pairs and gather_rows
    is held against its plain version on the same inputs, as the kernel
    checks do: gj_inv's Dinv bit-identical, min|pivot|, n_perturbed and
    the sign exact, log|det| at rtol 1e-14; splu_pairs at rtol 1e-12
    (``assert_close``); gather_rows bit-identical. Yields {kernel: {"calls",
    "shapes", "max_abs_err"}} (gj_inv: also "logdet_max_rel_err"), filled
    as the block runs. The wrappers keep counting their launches."""
    from russell_tpu_torch.sparse import splu
    names = {"gj_inv": "_gj_inv", "splu_pairs": "splu_pairs",
             "gather_rows": "gather_rows"}
    orig = {k: getattr(splu, a) for k, a in names.items()}
    held = {k: {"calls": 0, "shapes": collections.Counter(),
                "max_abs_err": 0.0} for k in names}
    held["gj_inv"]["logdet_max_rel_err"] = 0.0

    def note(k, shape, err):
        h = held[k]
        h["calls"] += 1
        h["shapes"][shape] += 1
        h["max_abs_err"] = max(h["max_abs_err"], err)

    def gj_inv(D, delta):
        got = orig["gj_inv"](D, delta)
        want = splu._gj_inv_plain(D, delta)
        w, m = D.shape[0], D.shape[-1]
        if not torch.equal(got[0], want[0]):
            raise AssertionError(
                f"gj_inv ({w}, {m}) on the path: Dinv differs from the plain "
                f"version by up to {float((got[0] - want[0]).abs().max())}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0,
                                   msg=lambda s: f"gj_inv ({w}, {m}) on the "
                                   f"path, log|det|: {s}")
        for name, g, p in (("min|pivot|", got[2], want[2]),
                           ("n_perturbed", got[3], want[3]),
                           ("sign", got[4], want[4])):
            if not torch.equal(g, p):
                raise AssertionError(f"gj_inv ({w}, {m}) on the path: {name} "
                                     "differs from the plain version")
        if w:   # the wrapper launches nothing for an empty batch
            note("gj_inv", (w, m), 0.0)
            h = held["gj_inv"]
            h["logdet_max_rel_err"] = max(h["logdet_max_rel_err"], float((
                (got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-300)
            ).max()))
        return got

    def splu_pairs(blocks, pair_l, pair_u, pair_seg, work, n_live, be):
        got = orig["splu_pairs"](blocks, pair_l, pair_u, pair_seg, work,
                                 n_live, be)
        want = splu._splu_pairs_plain(blocks, pair_l, pair_u, pair_seg,
                                      n_live, be)
        err, _ = assert_close(f"splu_pairs on the path ({n_live} lanes, "
                              f"{pair_l.numel()} pairs, be {be})", got, want)
        note("splu_pairs", (n_live, be), err)
        return got

    def gather_rows(blocks, idx):
        got = orig["gather_rows"](blocks, idx)
        if not torch.equal(got, splu._gather_rows_plain(blocks, idx)):
            raise AssertionError(f"gather_rows on the path ({idx.numel()} "
                                 "rows) differs from blocks[idx]")
        note("gather_rows", (idx.numel(), blocks.shape[1]), 0.0)
        return got

    checks = {"gj_inv": gj_inv, "splu_pairs": splu_pairs,
              "gather_rows": gather_rows}
    for k, a in names.items():
        checks[k].launches = orig[k].launches
        setattr(splu, a, checks[k])
    try:
        yield held
    finally:
        for k, a in names.items():
            orig[k].launches = checks[k].launches
            setattr(splu, a, orig[k])


def held_record(held, launches):
    """The record of a ``held_to_plain`` block that ran one factorization
    whose per-kernel launch counts were ``launches``: it fails unless every
    launch was held."""
    rec = {}
    for k, n in launches.items():
        h = held[k]
        if h["calls"] != n:
            raise AssertionError(f"{k}: {h['calls']} launches held against "
                                 f"the plain version, {n} in a factorization")
        if n:
            rec[k] = {"calls": h["calls"], "shapes": len(h["shapes"]),
                      "max_abs_err": h["max_abs_err"]}
            if "logdet_max_rel_err" in h:
                rec[k]["logdet_max_rel_err"] = h["logdet_max_rel_err"]
    return rec


def ls_genmf(res):
    """geometric_264k through LinSolver(Genie.GENMF), real; then the same
    pattern with complex values through factor on the solver's plan."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor, samples)
    coo = samples.irregular_geometric(GEOMETRIC_N, seed=0)
    ii, jj, vv = coo.triplets()
    n = coo.nrow
    rng = np.random.default_rng(SEED)
    b = rng.standard_normal(n)
    cv = vv + 0.3j * rng.standard_normal(len(vv))
    cb = b + 1j * rng.standard_normal(n)
    # AUTO's route for this matrix (host only): the reference package's
    # benchmark names GENMF (tools/bench_matrix_market.py:72)
    t0 = time.perf_counter()
    auto = factor.analyze(n, ii, jj)
    auto_s = time.perf_counter() - t0
    auto_rec = {"auto_routes_to": auto.genie.value,
                "auto_analyze_s": auto_s, "auto_block_k": auto.block_k}
    del auto
    reset_launch_counts()
    s = LinSolver(Genie.GENMF, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.factorize(coo, LinSolParams())
    cold = time.perf_counter() - t0
    counts = kernel_counts()
    if counts["gj_inv"] <= 0:
        raise AssertionError("GENMF 264k: gj_inv was not launched")
    gp = s.plan.genmf_plan
    rec = {"matrix": "geometric_264k", "n": n, "nnz": int(len(ii)),
           "solver": s.stats.main["solver"], **auto_rec,
           **gp.stats_dict(),
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "cold_total_s": cold, "launches_cold": counts}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["GFLOP_per_s_wall"] = gp.flops / rec["warm_median_s"] / 1e9
    rec["GFLOP_per_s_device"] = gp.flops / rec["device_ms"] / 1e6
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    if not rec["relative_error"] <= 1e-10:
        raise AssertionError(f"GENMF 264k: relative error "
                             f"{rec['relative_error']}")
    rec["min_pivot"] = s.stats.output["min_pivot"]
    rec["n_perturbed"] = s.stats.output["n_perturbed_pivots"]
    # bits: another factorize-and-solve
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.solve(b), x))
    # gj_inv against its plain version: at every launch of a factorization,
    # and at the base shapes of both runs' pivot blocks with clamped lanes
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(coo)
    rec["held_to_plain"] = held_record(held, {"gj_inv": rec[
        "gj_inv_launches"]})
    ld_err = check_gj_inv_shapes({
        "genmf_264k": collections.Counter(
            (c.n_nodes, c.e) for c in gp.classes),
        "genmf_264k_complex": collections.Counter(
            (c.n_nodes, 2 * c.e) for c in gp.classes)})[1]
    rec["gj_inv_shapes_logdet_max_rel_err"] = ld_err
    rec["kernel_checks_s"] = time.perf_counter() - t0
    oxs, ologdet, ophase, t_o = superlu_oracle(coo, vv, [b])
    rec.update(check_oracle("GENMF 264k", x, logdet, phase, oxs[0], ologdet,
                            ophase, LS_RTOL["genmf"]), superlu_s=t_o,
               logdet=logdet, det_phase=str(phase))
    say("lin_solver_path", part="genmf_264k", **rec)
    if not rec["bit_identical_repeat"]:
        raise AssertionError("GENMF 264k: a second factorize-and-solve "
                             "changed x")
    res["genmf_264k"] = rec
    plan = s.plan
    del s, x
    gc.collect()
    torch.cuda.empty_cache()

    # complex values on the same plan, through the planes
    cvt = torch.as_tensor(cv, device="cuda")
    cbt = torch.as_tensor(cb, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def fact():
        fac = factor.numeric_factorize(plan, cvt)
        float(fac["min_pivot"])
        return fac

    t0 = time.perf_counter()
    fac = fact()
    crec = {"cold_factorize_s": time.perf_counter() - t0}
    crec.update(timed_factorizations(fact))
    crec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    fac = fact()
    x = factor.factor_solve(plan, fac, cbt)
    crec["warm_solve_s"] = timed_solves(
        lambda: factor.factor_solve(plan, fac, cbt))
    logdet, phase = fac_log_phase(plan, fac)
    crec["relative_error"] = VerifyLinSys.from_system(
        coo.__class__.from_arrays(n, n, ii, jj, cv), x.cpu().numpy(),
        cb).relative_error
    if not crec["relative_error"] <= 1e-10:
        raise AssertionError(f"GENMF 264k complex: relative error "
                             f"{crec['relative_error']}")
    fac2 = fact()
    crec["bit_identical_repeat"] = bool(torch.equal(
        factor.factor_solve(plan, fac2, cbt), x))
    del fac2
    with held_to_plain() as held:
        fact()
    crec["held_to_plain"] = held_record(held, {"gj_inv": crec[
        "gj_inv_launches"]})
    oxs, ologdet, ophase, t_o = superlu_oracle(coo, cv, [cb])
    crec.update(check_oracle("GENMF 264k complex", x, logdet, phase, oxs[0],
                             ologdet, ophase, LS_RTOL["genmf"]),
                superlu_s=t_o, logdet=logdet, det_phase=str(phase),
                min_pivot=float(fac["min_pivot"]),
                n_perturbed=int(fac["n_perturbed"]))
    say("lin_solver_path", part="genmf_264k_complex", **crec)
    if not crec["bit_identical_repeat"]:
        raise AssertionError("GENMF 264k complex: a second factorize-and-"
                             "solve changed x")
    res["genmf_264k_complex"] = crec
    del fac, x, cvt, cbt
    gc.collect()
    torch.cuda.empty_cache()


def ls_banded(res):
    """laplacian_2d_317 through LinSolver(Genie.AUTO) (BANDED, cyclic
    reduction), the sequential scan on the same matrix, and a complex run
    through cyclic reduction."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, factor, samples)
    coo = samples.laplacian_2d(LAPLACIAN_2D_NPOINT)
    ii, jj, vv = coo.triplets()
    n = coo.nrow
    rng = np.random.default_rng(SEED + 1)
    b = rng.standard_normal(n)
    s = LinSolver(Genie.AUTO, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    s.factorize(coo, LinSolParams())
    plan = s.plan
    if not (plan.genie == Genie.BANDED and plan.block_k == 320
            and plan.nb == 315 and plan.use_bcr):
        raise AssertionError(f"laplacian_2d_317: AUTO took {plan.genie} "
                             f"k {plan.block_k} nb {plan.nb} bcr "
                             f"{plan.use_bcr}, not BANDED 320/315/BCR")
    rec = {"matrix": "laplacian_2d_317", "n": n, "nnz": int(len(ii)),
           "block_k": plan.block_k, "nb": plan.nb,
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.solve(b), x))
    cv = vv + 0.3j * rng.standard_normal(len(vv))
    cb = b + 1j * rng.standard_normal(n)
    oxs, ologdet, ophase, t_o = superlu_oracle(coo, vv, [b])
    rec.update(check_oracle("BANDED BCR 317", x, logdet, phase, oxs[0],
                            ologdet, ophase, LS_RTOL["banded"]),
               superlu_s=t_o)
    say("lin_solver_path", part="banded_bcr_317", **rec)
    if not (rec["relative_error"] <= 1e-10 and rec["bit_identical_repeat"]):
        raise AssertionError(f"BANDED BCR 317: relative error "
                             f"{rec['relative_error']} or bits changed")
    res["banded_bcr_317"] = rec
    x_bcr = x
    del s
    gc.collect()
    torch.cuda.empty_cache()

    # the sequential scan on the same matrix
    splan = factor.analyze(n, ii, jj, genie=Genie.BANDED,
                           banded_kernel="scan")
    vt = torch.as_tensor(vv, device="cuda")
    bt = torch.as_tensor(b, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def fact(p=splan, v=vt):
        fac = factor.numeric_factorize(p, v)
        float(fac["min_pivot"])
        return fac

    t0 = time.perf_counter()
    fact()
    srec = {"cold_factorize_s": time.perf_counter() - t0}
    srec.update(timed_factorizations(fact))
    srec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    fac = fact()
    x = factor.factor_solve(splan, fac, bt)
    srec["warm_solve_s"] = timed_solves(
        lambda: factor.factor_solve(splan, fac, bt))
    logdet, phase = fac_log_phase(splan, fac)
    srec["x_rel_err_vs_bcr"] = float((x - x_bcr).abs().max()
                                     / x_bcr.abs().max())
    srec.update(check_oracle("BANDED scan 317", x, logdet, phase, oxs[0],
                             ologdet, ophase, LS_RTOL["banded"]),
                n_perturbed=int(fac["n_perturbed"]),
                min_pivot=float(fac["min_pivot"]),
                bcr_over_scan_warm=rec["warm_median_s"]
                / srec["warm_median_s"])
    say("lin_solver_path", part="banded_scan_317", **srec)
    if not srec["x_rel_err_vs_bcr"] <= LS_RTOL["banded"]:
        raise AssertionError(f"BANDED 317: scan and BCR x differ by "
                             f"{srec['x_rel_err_vs_bcr']}")
    res["banded_scan_317"] = srec
    del fac, x, splan
    gc.collect()

    # complex128 through cyclic reduction
    cvt = torch.as_tensor(cv, device="cuda")
    cbt = torch.as_tensor(cb, device="cuda")
    t0 = time.perf_counter()
    fac = fact(plan, cvt)
    crec = {"cold_factorize_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fac = fact(plan, cvt)
    crec["warm_factorize_s"] = time.perf_counter() - t0
    x = factor.factor_solve(plan, fac, cbt)
    logdet, phase = fac_log_phase(plan, fac)
    crec["relative_error"] = VerifyLinSys.from_system(
        coo.__class__.from_arrays(n, n, ii, jj, cv), x.cpu().numpy(),
        cb).relative_error
    oxs, ologdet, ophase, t_o = superlu_oracle(coo, cv, [cb])
    crec.update(check_oracle("BANDED BCR 317 complex", x, logdet, phase,
                             oxs[0], ologdet, ophase, LS_RTOL["banded"]),
                superlu_s=t_o)
    say("lin_solver_path", part="banded_bcr_317_complex", **crec)
    if not crec["relative_error"] <= 1e-10:
        raise AssertionError(f"BANDED 317 complex: relative error "
                             f"{crec['relative_error']}")
    res["banded_bcr_317_complex"] = crec
    del fac, x, plan, cvt, cbt, vt, bt, x_bcr
    gc.collect()
    torch.cuda.empty_cache()


def ls_splu(res):
    """laplacian_3d through LinSolver(Genie.SPLU): splu_pairs, gather_rows
    and gj_inv on the path, two runs bit-identical."""
    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, samples)
    coo = samples.laplacian_3d(LAPLACIAN_3D_NPOINT)
    ii, jj, vv = coo.triplets()
    n = coo.nrow
    b = np.random.default_rng(SEED + 2).standard_normal(n)
    reset_launch_counts()
    s = LinSolver(Genie.SPLU, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    s.factorize(coo, LinSolParams())
    counts = kernel_counts()
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"SPLU via LinSolver: {k} was not launched")
    rec = {"matrix": f"laplacian_3d_{LAPLACIAN_3D_NPOINT}", "n": n,
           "nnz": int(len(ii)), "nblk": s.plan.splu_plan.nblk,
           "rows": len(s.plan.splu_plan.packed["t0"]),
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "launches_per_factorization": counts}
    rec.update(timed_factorizations(lambda: s.factorize(coo)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    x = s.solve(b)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(b))
    m, _, e = s.determinant()
    logdet, phase = det_log_phase(m, e)
    rec["relative_error"] = VerifyLinSys.from_system(
        coo, x.cpu().numpy(), b).relative_error
    blocks = s.fac["blocks"].clone()
    s.factorize(coo)
    rec["bit_identical_repeat"] = bool(torch.equal(s.fac["blocks"], blocks)
                                       and torch.equal(s.solve(b), x))
    # every kernel launch of a factorization against its plain version
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(coo)
    rec["held_to_plain"] = held_record(held, counts)
    rec["kernel_checks_s"] = time.perf_counter() - t0
    oxs, ologdet, ophase, t_o = superlu_oracle(coo, vv, [b])
    rec.update(check_oracle("SPLU via LinSolver", x, logdet, phase, oxs[0],
                            ologdet, ophase, LS_RTOL["splu"]),
               superlu_s=t_o)
    say("lin_solver_path", part="splu_3d", **rec)
    if not (rec["relative_error"] <= 1e-10 and rec["bit_identical_repeat"]):
        raise AssertionError(f"SPLU via LinSolver: relative error "
                             f"{rec['relative_error']} or bits changed")
    res["splu_3d"] = rec
    del s, x, blocks
    gc.collect()
    torch.cuda.empty_cache()


def ls_cli(res):
    """solve_matrix_market in a subprocess with its default flags (AUTO, on
    the card) on a MatrixMarket file of irregular_geometric(CLI_N); its
    solver must be the one factor.analyze picks for that matrix."""
    import tempfile
    from russell_tpu_torch.sparse import factor, samples, write_matrix_market
    root = os.path.dirname(os.path.abspath(__file__))
    coo = samples.irregular_geometric(CLI_N, seed=0)
    ii, jj, _ = coo.triplets()
    auto = factor.analyze(coo.nrow, ii, jj).genie.value
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"geometric_{CLI_N}.mtx")
        write_matrix_market(coo, path)
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "russell_tpu_torch.bin.solve_matrix_market",
             path, "--determinant"], cwd=root, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    out = proc.stdout
    if proc.returncode != 0 or "{" not in out:
        raise AssertionError(f"solve_matrix_market exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    st = json.loads(out[out.index("{"):])
    rec = {"rc": proc.returncode, "wall_s": wall, "auto_routes_to": auto,
           "solver": st["main"]["solver"], "platform": st["main"]["platform"],
           "relative_error": st["verify"]["relative_error"],
           "time_ns": st["time_nanoseconds"]}
    say("lin_solver_path", part="cli", n=CLI_N, **rec)
    if (rec["solver"].lower() != auto
            or not rec["relative_error"] <= 1e-10):
        raise AssertionError(f"solve_matrix_market: {rec}")
    res["cli"] = rec


def phase_lin_solver_path():
    """LinSolver on the card at the reference's sparse benchmark sizes
    (GENMF geometric_264k real and complex, BANDED laplacian_2d_317 by
    cyclic reduction and by the scan, SPLU laplacian_3d_50) against SciPy's
    SuperLU, then the solve_matrix_market CLI."""
    t0 = time.perf_counter()
    res = {}
    ls_genmf(res)
    ls_banded(res)
    ls_splu(res)
    ls_cli(res)
    say("lin_solver_path", part="done", wall_s=time.perf_counter() - t0)
    return res


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    plan = brusselator_plan(NPOINT)
    plan_rows = len(plan.splu_plan.packed["t0"])
    say("plan", npoint=NPOINT, ndim=plan.n, nblk=plan.splu_plan.nblk,
        rows=plan_rows, TL=plan.splu_plan.packed["TL"],
        C=int(plan.splu_plan.packed["pair_l"].shape[1]))
    phase_warmup()
    kres = phase_kernels(plan)
    phase_van_der_pol()
    phase_brusselator_small()
    phase_gridmf_small()
    sol, y, runs = phase_main_path(plan_rows)
    splu_y = y.clone()
    phase_layers(sol, y)
    del sol, y
    torch.cuda.empty_cache()
    gruns, gridmf_y = phase_gridmf_main_path(runs["warm"]["counters"],
                                             splu_y)
    splu_host = {"counters": runs["warm"]["counters"], "y": splu_y.cpu(),
                 "wall_s": runs["warm"]["wall_s"]}
    gridmf_host = {"counters": gruns[-1]["counters"], "y": gridmf_y,
                   "warm_median_s": statistics.median(
                       r["wall_s"] for r in gruns[1:])}
    del splu_y
    torch.cuda.empty_cache()
    gplans = phase_gridmf_layers()
    gres = phase_gj_inv(plan, gplans)
    del gplans
    rep = phase_replay(plan)
    phase_ode_samples()
    erk_recs, erk_ys = phase_erk_path()
    erk_host = {(r["method"], r["npoint"]): {
        "counters": r["counters"], "wall_s": r["wall_s"],
        "y": erk_ys[(r["method"], r["npoint"])]} for r in erk_recs}
    phase_bweuler_path()
    phase_dense_factor()
    phase_bsr_kernels()
    bsr_launches, bres = phase_bsr_path()
    cres = phase_bsr_complex()
    fres = phase_fused_path(gridmf_host, splu_host, erk_host)
    lres = phase_lin_solver_path()
    src = {"splu_pairs": ("russell_tpu_torch/csrc/splu_pairs.cu",
                          "russell_tpu/sparse/splu.py:561"),
           "gather_rows": ("russell_tpu_torch/csrc/gather_rows.cu",
                           "russell_tpu/sparse/splu.py:634"),
           "bsr_spmv": ("russell_tpu_torch/csrc/bsr_spmv.cu",
                        "russell_tpu/sparse/kernels.py:106"),
           "bsr_spmm": ("russell_tpu_torch/csrc/bsr_spmm.cu",
                        "russell_tpu/sparse/kernels.py:186"),
           "spgemm_blocks": ("russell_tpu_torch/csrc/spgemm_blocks.cu",
                             "russell_tpu/sparse/kernels.py:306"),
           "gj_inv": ("russell_tpu_torch/csrc/gj_inv.cu",
                      "russell_tpu/sparse/splu.py:476 (plain XLA)")}
    kernels = []
    b = plan.splu_plan.b
    for name, row in (("splu_pairs", "argmax_pairs"),
                      ("gather_rows", "argmax_len")):
        # one factorize row: the real (b) and complex (2b) states summed
        res = [kres[(name, row, be)] for be in (b, 2 * b)]
        lib = [r[3] for r in res]
        by = max(res, key=lambda r: r[4])[5]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1],
            "launches": runs["warm"]["launches"][name],
            "max_abs_err": max(v[0] for k, v in kres.items()
                               if k[0] == name),
            "ms": sum(r[1] for r in res),
            "ms_cold_l2": sum(r[6] for r in res),
            "plain_ms": sum(r[2] for r in res),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(r[4] for r in res), "bound_by": by,
            "replay_ms_per_factorize_pair": rep[f"{name}_ms"],
            "fused_path": fused_entry(fres, name),
            "launches_lin_solver_path_splu_3d_per_factorization": lres[
                "splu_3d"]["launches_per_factorization"][name],
            "lin_solver_path_splu_3d_held_to_plain": lres["splu_3d"][
                "held_to_plain"][name],
            "shapes": f"npoint-129 SPLU factorize row ({row}), b 32 + 2b 64"})
    for name, res in bres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": bsr_launches[name],
            **res, "shapes": f"npoint-{NPOINT_BSR} Brusselator Jacobian",
            "fused_path": fused_entry(fres, name),
            "complex128": {k: cres[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}})
    kernels.append({
        "name": "gj_inv", "route": "cuda", "source": src["gj_inv"][0],
        "replaces": src["gj_inv"][1],
        "launches": gruns[-1]["gj_inv_launches"], **gres,
        "launches_splu_main_path": runs["warm"]["launches"]["gj_inv"],
        "fused_path": fused_entry(fres, "gj_inv"),
        "lin_solver_path": {
            "genmf_264k_launches_per_factorization": lres["genmf_264k"][
                "gj_inv_launches"],
            "genmf_264k_ms_per_factorization": lres["genmf_264k"][
                "gj_inv_device_ms"],
            "genmf_264k_complex_launches_per_factorization": lres[
                "genmf_264k_complex"]["gj_inv_launches"],
            "genmf_264k_complex_ms_per_factorization": lres[
                "genmf_264k_complex"]["gj_inv_device_ms"],
            "splu_3d_launches_per_factorization": lres["splu_3d"][
                "launches_per_factorization"]["gj_inv"],
            "held_to_plain": {part: lres[part]["held_to_plain"]["gj_inv"]
                              for part in ("genmf_264k",
                                           "genmf_264k_complex",
                                           "splu_3d")},
            "genmf_264k_shapes_logdet_max_rel_err": lres["genmf_264k"][
                "gj_inv_shapes_logdet_max_rel_err"]},
        "shapes": f"the base calls of one npoint-{NPOINT} GRIDMF factorize "
                  "pair, summed (inv_block: per factorize pair, the "
                  "top-level pivot blocks)"})
    kernels.append({
        **fres["lane_pow"],
        "launches": fres["gridmf_129"]["launches_cold_run"]["lane_pow"],
        "fused_path": fused_entry(fres, "lane_pow"),
        "shapes": "one lane (the fused solves), 64 lanes (solve_batch)"})
    say("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def bsr_ab_times():
    """bsr_matvec and bsr_matmat (m = SPMM_M) at 8x128 and spgemm (A·A) at
    16x16 on the npoint-513 Jacobian through the public entry points of
    this process's package: the host seconds of the first call of each on a
    new matrix (for spgemm after its spgemm_plan) and of the first
    bsr_matvec and spgemm after an in-place update of the blocks (each a
    product plus, in a package that derives a layout from the blocks, its
    build), after each was called once on the npoint-9 Jacobian so that
    none pays for loading the kernels; then each timed back to back
    (``time_ms``)."""
    from russell_tpu_torch.sparse import (bsr_from_coo, bsr_matmat,
                                          bsr_matvec, spgemm, spgemm_plan)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    small_coo = brusselator_jacobian(9)
    small = bsr_from_coo(small_coo, 8, 128, dev)
    bsr_matvec(small, torch.ones(small.n_cols, dtype=torch.float64,
                                 device=dev))
    bsr_matmat(small, torch.ones((small.n_cols, SPMM_M), dtype=torch.float64,
                                 device=dev))
    small = bsr_from_coo(small_coo, 16, 16, dev)
    spgemm(spgemm_plan(small, small), small, small)
    coo = brusselator_jacobian(NPOINT_BSR)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=dev)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, SPMM_M)), device=dev)
    bsr8 = bsr_from_coo(coo, 8, 128, dev)
    y, first_matvec_s = first_call_s(lambda: bsr_matvec(bsr8, x))
    Y, first_matmat_s = first_call_s(lambda: bsr_matmat(bsr8, X))
    rec = {"bsr_matvec_ms": time_ms(lambda: bsr_matvec(bsr8, x)),
           "bsr_matmat_ms": time_ms(lambda: bsr_matmat(bsr8, X)),
           "bsr_first_matvec_s": first_matvec_s,
           "bsr_first_matmat_s": first_matmat_s,
           "y_sum": float(y.sum()), "Y_sum": float(Y.sum())}
    bsr8.blocks.mul_(1.0)
    _, rec["bsr_updated_matvec_s"] = first_call_s(
        lambda: bsr_matvec(bsr8, x))
    del bsr8
    torch.cuda.empty_cache()
    bsr16 = bsr_from_coo(coo, 16, 16, dev)
    plan = spgemm_plan(bsr16, bsr16)
    (C, _), rec["spgemm_first_s"] = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    rec["C_sum"] = float(C.sum())
    del C
    rec["spgemm_ms"] = time_ms(lambda: spgemm(plan, bsr16, bsr16))
    bsr16.blocks.mul_(1.0)
    _, rec["spgemm_updated_s"] = first_call_s(
        lambda: spgemm(plan, bsr16, bsr16))
    return rec


def gridmf_replay(npoint):
    """One GRIDMF factorize pair at ``npoint`` (the leaf AUTO picks) as
    ``gridmf_pair_record`` measures it, under keys of the npoint."""
    plan, vr, vc, _ = gridmf_setup(npoint)
    rec = gridmf_pair_record(plan, vr, vc)
    del plan, vr, vc
    torch.cuda.empty_cache()
    return {f"gridmf_{npoint}_{k}": rec[f"factorize_pair_{k}"] for k in (
        "device_launches", "device_ms", "profiled_wall_ms",
        "wall_median_ms")}


def default_path_walls(warm_runs=3):
    """``default_path_runs``: the cold wall, the warm walls, their median
    and spread, and the last run's counters."""
    recs = [rec for rec, _, _ in default_path_runs(warm_runs)]
    warm = [r["wall_s"] for r in recs[1:]]
    return {"default_cold_wall_s": recs[0]["wall_s"],
            "default_warm_walls_s": warm,
            "default_warm_median_s": statistics.median(warm),
            "default_warm_spread_s": max(warm) - min(warm),
            "default_counters": recs[-1]["counters"]}


def main_replay():
    """--replay [--tree DIR]: one line, the replay of this package (or
    DIR's) on the npoint-129 SPLU factorize pair, one GRIDMF factorize pair
    at npoint 129 and 513, the default path's walls at npoint 129, then its
    BSR SpMV, SpMM and SpGEMM times on the npoint-513 Jacobian."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    rec = replay(replay_setup())
    torch.cuda.empty_cache()
    for npoint in (NPOINT, NPOINT_BSR):
        rec.update(gridmf_replay(npoint))
    rec.update(default_path_walls())
    torch.cuda.empty_cache()
    print(json.dumps({**rec, **bsr_ab_times()}), flush=True)


def main_ab(parent, rounds):
    """--ab PARENT [ROUNDS]: ``main_replay`` with the parent tree's package
    (``git archive`` of the parent commit unpacked at PARENT) and with this
    tree's, each in its own process, in turns P C C P, ROUNDS times, on one
    card; then the medians of each number and the ratios change /
    parent."""
    phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent") * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--replay", "--tree",
             trees[which]], cwd=trees[which], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"replay of {which} failed:\n"
                               f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if not rec["package"].startswith(trees[which]):
            raise AssertionError(f"{which} ran {rec['package']}")
        say("ab_replay", tree=which, **rec)
        runs[which].append(rec)
    keys = ("splu_pairs_ms", "gather_rows_ms", "gj_inv_ms",
            "device_busy_ms", "device_launches", "profiled_wall_s",
            *(f"gridmf_{n}_{k}" for n in (NPOINT, NPOINT_BSR) for k in (
                "device_launches", "device_ms", "profiled_wall_ms",
                "wall_median_ms")),
            "default_cold_wall_s", "default_warm_median_s",
            "default_warm_spread_s",
            "bsr_matvec_ms", "bsr_matmat_ms",
            "bsr_first_matvec_s", "bsr_first_matmat_s",
            "bsr_updated_matvec_s", "spgemm_ms", "spgemm_first_s",
            "spgemm_updated_s")
    med = {which: {k: statistics.median(r[k] for r in recs) for k in keys}
           for which, recs in runs.items()}
    p, c = med["parent"], med["change"]

    def break_even(ms, first_s):
        """Calls on one matrix (one layout build, whose cost is in the
        first call ``first_s``) after which the change has spent less time
        than the parent: 0 if its first call is no dearer."""
        saved_ms = p[ms] - c[ms]
        extra_ms = 1e3 * (c[first_s] - p[first_s])
        if extra_ms <= 0:
            return 0.0
        return extra_ms / saved_ms if saved_ms > 0 else None

    say("ab", order="P C C P", rounds=rounds, median=med,
        counters={w: [r["default_counters"] for r in recs]
                  for w, recs in runs.items()},
        bsr_matvec_break_even_products=break_even("bsr_matvec_ms",
                                                  "bsr_first_matvec_s"),
        bsr_matvec_break_even_after_update=break_even(
            "bsr_matvec_ms", "bsr_updated_matvec_s"),
        spgemm_break_even_calls=break_even("spgemm_ms", "spgemm_first_s"),
        spgemm_break_even_after_update=break_even("spgemm_ms",
                                                  "spgemm_updated_s"),
        ratio={k: c[k] / p[k] for k in keys if p[k]})


def base_sweep(bases=BASE_SWEEP, rounds=2):
    """The factorize pairs whose pivot inverses reach gj_inv (GRIDMF at
    npoint 129 and 513 at the leaf AUTO picks, 513 at leaf 16, SPLU at
    129) with ``splu.GJ_MAX_M`` set to each base of ``bases`` in turn,
    ``rounds`` times in alternating order: the device launches, device ms
    and profiled wall of one pair under the profiler and the median wall of
    three, which is how GJ_MAX_M was chosen."""
    from russell_tpu_torch.sparse import factor, splu
    default = splu.GJ_MAX_M
    setups = {"splu_129": lambda: replay_setup()}
    for name, npoint, leaf in (("gridmf_129", NPOINT, None),
                               ("gridmf_513", NPOINT_BSR, None),
                               ("gridmf_513_leaf16", NPOINT_BSR, 16)):
        setups[name] = (lambda npoint=npoint, leaf=leaf:
                        gridmf_setup(npoint, leaf)[:3])
    try:
        for name, setup in setups.items():
            plan, vr, vc = setup()
            order = list(bases)
            for rnd in range(rounds):
                for base in (order if rnd % 2 == 0 else order[::-1]):
                    splu.GJ_MAX_M = base

                    def pair():
                        return factor.numeric_factorize_pair(plan, vr, vc)
                    pair()
                    torch.cuda.synchronize()
                    walls = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        pair()
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                    n0 = gj_inv_launches()
                    ms, wall, launches = kernel_device_ms(pair)
                    say("base_sweep", pair=name, gj_max_m=base, round=rnd,
                        device_launches=launches,
                        gj_inv_launches=gj_inv_launches() - n0,
                        device_ms=sum(ms.values()),
                        gj_inv_ms=summed(ms, "gj_inv"),
                        gemm_ms=sum(v for k, v in ms.items()
                                    if "gemm" in k.lower()),
                        profiled_wall_ms=1e3 * wall,
                        wall_median_ms=1e3 * statistics.median(walls))
            del plan, vr, vc
            torch.cuda.empty_cache()
    finally:
        splu.GJ_MAX_M = default


def strip_sweep():
    """spgemm on the npoint-513 Jacobian (16x16, A·A) for each strip budget
    of STRIP_SWEEP (``kernels.SPGEMM_STRIP_BYTES``): the L2-cold and
    back-to-back times and the bits against the default budget's, which is
    how the budget was chosen."""
    from russell_tpu_torch.sparse import (bsr_from_coo, kernels, spgemm,
                                          spgemm_plan)
    bsr16 = bsr_from_coo(brusselator_jacobian(NPOINT_BSR), 16, 16,
                         torch.device("cuda"))
    plan = spgemm_plan(bsr16, bsr16)
    want = spgemm(plan, bsr16, bsr16)[0]
    most = kernels._device_plan(plan, want.device)["max_row_blocks"]
    b_ms = bound(*spgemm_work(plan, bsr16, bsr16))[0]
    default = kernels.SPGEMM_STRIP_BYTES
    try:
        for budget in STRIP_SWEEP:
            kernels.SPGEMM_STRIP_BYTES = budget
            same = torch.equal(spgemm(plan, bsr16, bsr16)[0], want)
            ms = cold_ms(lambda: spgemm(plan, bsr16, bsr16))
            say("strip_sweep", budget=budget, strip=kernels._strip_chunks(
                16, 16, most), ms=ms,
                ms_warm_l2=time_ms(lambda: spgemm(plan, bsr16, bsr16)),
                share=b_ms / ms, bit_identical=same)
            if not same:
                raise AssertionError(f"spgemm: budget {budget} changes the "
                                     "bits")
    finally:
        kernels.SPGEMM_STRIP_BYTES = default


if __name__ == "__main__":
    if "--replay" in sys.argv:
        main_replay()
    elif "--chunk-sweep" in sys.argv:
        phase_device()
        phase_build()
        chunk_sweep(brusselator_plan(NPOINT))
    elif "--strip-sweep" in sys.argv:
        phase_device()
        phase_build()
        strip_sweep()
    elif "--base-sweep" in sys.argv:
        phase_device()
        phase_build()
        base_sweep()
    elif "--lin-solver-path" in sys.argv:
        phase_device()
        phase_build()
        phase_lin_solver_path()
    elif "--ab" in sys.argv:
        i = sys.argv.index("--ab")
        main_ab(sys.argv[i + 1],
                int(sys.argv[i + 2]) if len(sys.argv) > i + 2 else 1)
    else:
        main()
