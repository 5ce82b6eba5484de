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
complex128. The PDE and continuation tools (``russell_tpu_torch.pde``,
``nonlin``) reach the card through ``LinSolver`` and ``factor``.

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel compiled from ``russell_tpu_torch/csrc``, one
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
22. pde_path: the PDE tools on the card. Poisson (``d2_problem_01``) on a
   PDE_NPOINT^2 grid (1,046,529 unknowns): the SPS system ``Fdm2d``
   builds, through one ``LinSolver`` with its grid hint (AUTO -> GRIDMF at
   leaf 64): host assembly, analysis, a cold and three warm
   factorizations (walls, device ms, launches, busy share, ``gj_inv``'s
   launches and ms, peak memory), one more with every ``gj_inv`` launch
   held to its plain version, a solve, the relative residual <= 1e-10
   and the error against the analytic phi <= PDE_ERR; then two
   ``solve_sps`` calls, bit-identical to each other and to that x. The
   same problem at PDE_SPLU_NPOINT^2 through ``Genie.SPLU`` with
   ``splu_pairs``, ``gather_rows`` and ``gj_inv`` counted from zero over a
   ``solve_sps``, x within 1e-10 of GRIDMF's, and a second ``solve_sps``
   with every launch held to its plain version (``held_to_plain``),
   bit-identical; ``Spc2d`` on Kopriva's problem at PDE_SPC_N^2 and
   ``SpcMap2d`` on the quarter ring through DENSE, against the analytic
   solutions. The kernels line gains each kernel's pde_path launches.
23. nonlin_path: the continuation solvers on the card. The 2-D Bratu
   problem by arclength at npoint 17 (russell_tpu's eight counters and
   step lambdas, written here as constants; the fold polished by
   extended-system Newton in torch on the card, within 1e-5 of
   6.80217410) and at BRATU_BIG with the default Config (ndim 65,025;
   AUTO's route, steps, factorizations, walls, the busy share of the
   solve over its first steps, the sample and the Solver built outside
   that window; lambda rises to its largest recorded value and falls
   while u_mid reaches 6; from the step at that value the fold polished
   by extended-system Newton through ``factor`` on the card, within
   BRATU_BIG_FOLD_TOL of Bolstad & Keller's value less the h^2 and h^4
   terms fitted to russell_tpu's folds at npoint 17 and 33, and above
   every recorded lambda; a second run with equal counters and bit-equal
   u); natural
   continuation on the 1-D Bratu and the B-spline problems with
   russell_tpu's counters. No hand kernel is on this path (DENSE and
   BANDED run cuSOLVER and cuBLAS).
24. lab_path: ``core``, ``math``, ``dense`` and ``algo`` at the sizes their
   users run, each result held to an oracle on the host. Dense f64 at
   LAB_N (``mat_mat_mul``, ``mat_cholesky``, ``solve_lin_sys``,
   ``mat_inverse`` with its det against numpy's slogdet,
   ``mat_eigen_sym``), ``mat_eigen_herm`` in complex128, ``mat_svd`` and
   ``mat_pseudo_inverse`` at LAB_N_HERM, ``mat_eigen`` batched and
   ``mat_gen_eigen`` at LAB_N_EIG: each held by its invariant against a
   seeded vector (residuals relative to the operands' norms <= 1e-12),
   with the first call's wall and device ms (set-up), the median of
   LAB_REPS calls after it and GFLOP/s where the flops are defined. Then
   ``jacobi_eig`` (``csrc/jacobi_eig.cu``) bit for bit against its plain
   version run on the CPU at JACOBI_PLAIN_N (the largest also through the
   global-memory route), the plain version on the card once, and
   ``mat_eigen_sym_jacobi`` at JACOBI_N (its launches counted from 0 over
   those calls) against ``torch.linalg.eigh`` (eigenvalues, |A V - V w|
   and |V^T V - I|): time, bound, barriers; its launch at JACOBI_N[0] is
   held bit for bit to the plain version, run on the CPU in a process of
   its own while the phase goes on. Then
   every elementwise public function of ``math`` on LAB_POINTS seeded
   points with the edge values first (poles, 0, +-1, negative arguments,
   the Bessel branch limits 8, 17, 26): every LAB_ORACLE_STRIDE-th point
   against ``scipy.special`` at tests/test_math.py's tolerances (``beta``
   and ``ln_beta`` at max(a, b) >= 8 at the reference's deviation from
   scipy there), the first LAB_CPU_POINTS against the port's CPU run
   (LAB_CPU_TOL where scipy is held more loosely); points/s and launches
   a call of ``bessel_jn(50)``, ``bessel_in(50)`` and ``elliptic_pi``.
   Then ``NewtonSolver`` at NEWTON_N (counters and u against the CPU run;
   u against a numpy Newton oracle), ``InterpChebyshev`` adapted then
   evaluated on LAB_POINTS points against its CPU evaluation, and
   ``RootFinder``, ``MinSolver`` and ``Quadrature`` (host work) with the
   reference's counters. The kernels line gains ``jacobi_eig``.

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
phases), ``--pde-nonlin`` only phases 22 and 23, ``--lab`` only phase 24
(with its kernels line and the last line). ``--chunk-sweep`` times
``splu_pairs`` over every row of the npoint-129 plan for each chunk size
K of CHUNK_SWEEP, which is how ``splu.CHUNK_PAIRS`` was chosen;
``--strip-sweep`` times ``spgemm`` at npoint 513 for each strip budget of
STRIP_SWEEP, which is how ``kernels.SPGEMM_STRIP_BYTES`` was chosen;
``--base-sweep`` runs the factorize pairs that reach ``gj_inv`` for each
recursion base of BASE_SWEEP, which is how ``splu.GJ_MAX_M`` was chosen.
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
    dense = sys.modules.get("russell_tpu_torch.dense.matrix_ops")
    if dense is not None:
        dense.reset_launch_counts()


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
    and fills, each counted whatever its duration: an event recorded with
    0 device time is a launch too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    launches = sum(e.device_type == DeviceType.CUDA for e in prof.events())
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



# -- pde_path ------------------------------------------------------------------

PDE_NPOINT = 1025       # Poisson at 1,046,529 unknowns: AUTO -> GRIDMF
PDE_SPLU_NPOINT = 513   # the same problem through Genie.SPLU
PDE_SPC_N = 48          # Spc2d on Kopriva's problem, through DENSE
PDE_RING_N = 15         # SpcMap2d on the quarter ring (tests/test_pde.py)
# the leaf fronts' eliminated cells that gridmf_analyze makes for this grid
# at leaf 64 (49 at leaf 16): AUTO takes leaf 64 (3 x 3.06 GiB <= 15)
PDE_LEAF64_E = 225
PDE_RES_RTOL = 1e-10
# tests/test_pde.py:101-107's 5e-5 at 41 x 41, scaled by h^2 (with room)
PDE_ERR = 2e-7
PDE_SPC_ERR = 1e-9      # tests/test_pde.py's bound for Kopriva at 24 x 24
PDE_RING_ERR = 1e-9     # tests/test_pde.py's bound for the ring


def poisson_fdm(npoint, genie=None):
    """``d2_problem_01(True)`` (Poisson, homogeneous Dirichlet, analytic phi)
    on an npoint x npoint grid, solving on the card: (fdm, source, phi)."""
    from russell_tpu_torch.pde import Fdm2d, Grid2d, problem_samples
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, ana, _) = \
        problem_samples.d2_problem_01(True)
    grid = Grid2d.new_uniform(xmin, xmax, ymin, ymax, npoint, npoint)
    fdm = Fdm2d(grid, ebcs, nbcs, kx, ky, device="cuda")
    if genie is not None:
        fdm.set_solver_options(genie)
    return fdm, src, ana


def max_error(solver, a, ana):
    """max |a[m] - ana(x_m, y_m)| over the solver's nodes."""
    err = [0.0]

    def cb(m, x, y):
        err[0] = max(err[0], abs(a[m] - ana(x, y)))

    solver.for_each_coord(cb)
    return err[0]


def timed_user_solve(fdm, src):
    """``fdm.solve_sps(0, src)`` — the user's call: host assembly, analysis,
    factorization and solve — with its wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = fdm.solve_sps(0.0, src)
    return a, time.perf_counter() - t0


def pde_gridmf(res):
    """Poisson at PDE_NPOINT through one LinSolver on the SPS system that
    ``Fdm2d.solve_sps`` builds (AUTO + the grid hint: GRIDMF): assembly,
    analysis, a cold and three warm factorizations, one more with every
    gj_inv launch held to its plain version, a solve, the residual
    and the error against phi; then ``solve_sps`` twice, bit-identical to
    each other and to the LinSolver's x."""
    from russell_tpu_torch.sparse import Genie, LinSolParams, LinSolver
    from russell_tpu_torch.sparse import gridmf
    fdm, src, ana = poisson_fdm(PDE_NPOINT)
    t0 = time.perf_counter()
    kk_bar, kk_check = fdm.get_matrices_sps(0.0)
    _, a_check, f_bar = fdm.get_vectors_sps(src)
    rhs = f_bar - kk_check.mat_vec_mul(a_check)
    assembly_s = time.perf_counter() - t0
    hint = fdm._sps_grid_hint()
    if hint != (PDE_NPOINT - 2, PDE_NPOINT - 2, 1):
        raise AssertionError(f"pde_path: grid hint {hint}")
    reset_launch_counts()
    s = LinSolver(Genie.AUTO, device="cuda")
    params = LinSolParams()
    params.grid = hint
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.factorize(kk_bar, params)
    cold = time.perf_counter() - t0
    if s.plan.genie != Genie.GRIDMF:
        raise AssertionError(f"pde_path: AUTO took {s.plan.genie}")
    gp = s.plan.gridmf_plan
    leaf_e = gp.levels[-1].e
    if leaf_e != PDE_LEAF64_E:
        raise AssertionError(f"pde_path: leaf fronts of {leaf_e} cells, not "
                             "leaf 64's")
    launches = kernel_counts()
    if launches["gj_inv"] <= 0:
        raise AssertionError("pde_path: gj_inv was not launched")
    rec = {"npoint": PDE_NPOINT, "n": kk_bar.nrow, "nnz": kk_bar.nnz,
           "solver": s.stats.main["solver"], "grid_hint": list(hint),
           "assembly_s": assembly_s,
           "analyze_s": s.stats.time_nanoseconds["initialize"] / 1e9,
           "leaf_e": leaf_e, "depths": len(gp.levels),
           "store_gb_per_plane": gridmf.gridmf_store_gb(gp),
           "cold_factorize_s": s.stats.time_nanoseconds["factorize"] / 1e9,
           "cold_total_s": cold, "launches_cold_factorization": launches}
    rec.update(timed_factorizations(lambda: s.factorize(kk_bar)))
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    # one more factorization with every gj_inv launch held to its plain
    # version: the leaf fronts and the Schur-split separators at this grid
    # are shapes that no other phase checks
    t0 = time.perf_counter()
    with held_to_plain() as held:
        s.factorize(kk_bar)
    rec["held_to_plain"] = held_record(held, launches)
    rec["held_wall_s"] = time.perf_counter() - t0
    x = s.solve(rhs)
    rec["warm_solve_s"] = timed_solves(lambda: s.solve(rhs))
    b = torch.as_tensor(rhs, device="cuda")
    rec["relative_residual"] = residual(s.plan, s._vals_full, x, b)
    a_ls = fdm.get_joined_vector_sps(x.cpu().numpy(), a_check)
    rec["max_error_vs_phi"] = max_error(fdm, a_ls, ana)
    del s, x, b
    gc.collect()
    torch.cuda.empty_cache()
    a1, rec["solve_sps_wall_s"] = timed_user_solve(fdm, src)
    a2, rec["solve_sps_again_wall_s"] = timed_user_solve(fdm, src)
    rec["bit_identical_repeat"] = bool(np.array_equal(a1, a2))
    rec["solve_sps_equals_lin_solver"] = bool(np.array_equal(a1, a_ls))
    say("pde_path", part=f"gridmf_{PDE_NPOINT}", **rec)
    if not (rec["relative_residual"] <= PDE_RES_RTOL
            and rec["max_error_vs_phi"] <= PDE_ERR):
        raise AssertionError(f"pde_path GRIDMF: residual "
                             f"{rec['relative_residual']}, error "
                             f"{rec['max_error_vs_phi']}")
    if not (rec["bit_identical_repeat"] and rec["solve_sps_equals_lin_solver"]):
        raise AssertionError("pde_path GRIDMF: solve_sps changed bits")
    res[f"gridmf_{PDE_NPOINT}"] = rec


def pde_splu(res):
    """The same problem at PDE_SPLU_NPOINT through ``Genie.SPLU``, its
    kernels counted from zero over a ``solve_sps``; x held to the GRIDMF
    solution at that size; a second ``solve_sps`` with every launch held
    to its plain version, bit-identical to the first."""
    from russell_tpu_torch.sparse import Genie
    fdm, src, ana = poisson_fdm(PDE_SPLU_NPOINT, Genie.SPLU)
    reset_launch_counts()
    a, wall = timed_user_solve(fdm, src)
    counts = kernel_counts()
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"pde_path SPLU: {k} was not launched")
    gfdm, _, _ = poisson_fdm(PDE_SPLU_NPOINT)
    reset_launch_counts()
    ag, gwall = timed_user_solve(gfdm, src)
    rec = {"npoint": PDE_SPLU_NPOINT, "n": fdm.equations.nu(),
           "solve_sps_wall_s": wall, "launches_solve_sps": counts,
           "gridmf_solve_sps_wall_s": gwall,
           "gridmf_gj_inv_launches": kernel_counts()["gj_inv"],
           "rel_diff_vs_gridmf": float(np.abs(a - ag).max()
                                       / np.abs(ag).max()),
           "max_error_vs_phi": max_error(fdm, a, ana)}
    t0 = time.perf_counter()
    with held_to_plain() as held:
        a2 = fdm.solve_sps(0.0, src)
    rec["held_to_plain"] = held_record(held, counts)
    rec["held_wall_s"] = time.perf_counter() - t0
    rec["bit_identical_repeat"] = bool(np.array_equal(a, a2))
    say("pde_path", part=f"splu_{PDE_SPLU_NPOINT}", **rec)
    if not (rec["rel_diff_vs_gridmf"] <= 1e-10
            and rec["bit_identical_repeat"]):
        raise AssertionError(f"pde_path SPLU: {rec}")
    res[f"splu_{PDE_SPLU_NPOINT}"] = rec


def quarter_ring():
    """The quarter annulus r in [1, 2], theta in [0, pi/2] of
    tests/test_pde.py, as a Transfinite2d."""
    import math
    from russell_tpu_torch.pde import Transfinite2d
    a, b_ = 1.0, 2.0
    q = math.pi / 4

    def th(s):
        return (s + 1.0) * q

    B = [lambda s: np.array([a * math.cos(th(s)), a * math.sin(th(s))]),
         lambda s: np.array([b_ * math.cos(th(s)), b_ * math.sin(th(s))]),
         lambda r: np.array([(a + b_) / 2 + (b_ - a) / 2 * r, 0.0]),
         lambda r: np.array([0.0, (a + b_) / 2 + (b_ - a) / 2 * r])]
    dB = [lambda s: np.array([-a * math.sin(th(s)) * q,
                              a * math.cos(th(s)) * q]),
          lambda s: np.array([-b_ * math.sin(th(s)) * q,
                              b_ * math.cos(th(s)) * q]),
          lambda r: np.array([(b_ - a) / 2, 0.0]),
          lambda r: np.array([0.0, (b_ - a) / 2])]
    ddB = [lambda s: np.array([-a * math.cos(th(s)) * q ** 2,
                               -a * math.sin(th(s)) * q ** 2]),
           lambda s: np.array([-b_ * math.cos(th(s)) * q ** 2,
                               -b_ * math.sin(th(s)) * q ** 2]),
           lambda r: np.array([0.0, 0.0]),
           lambda r: np.array([0.0, 0.0])]
    return Transfinite2d(B, dB, ddB)


def pde_spectral(res):
    """Spc2d on Kopriva's problem at PDE_SPC_N^2 and SpcMap2d on the
    quarter ring at PDE_RING_N^2, through DENSE on the card, against the
    analytic solutions."""
    import math
    from russell_tpu_torch.pde import (EssentialBcs2d, NaturalBcs2d, Side,
                                       Spc2d, SpcMap2d, problem_samples)
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, ana) = \
        problem_samples.d2_problem_07()
    t0 = time.perf_counter()
    spc = Spc2d(xmin, xmax, ymin, ymax, PDE_SPC_N, PDE_SPC_N, ebcs, nbcs,
                kx, ky, device="cuda")
    a = spc.solve_sps(0.0, src)
    rec = {"spc2d_n": PDE_SPC_N, "spc2d_unknowns": spc.equations.nu(),
           "spc2d_wall_s": time.perf_counter() - t0,
           "spc2d_max_error": max_error(spc, a, ana)}
    ring_ana = lambda x, y: math.log(math.hypot(x, y)) / math.log(2.0)
    ebcs = EssentialBcs2d()
    ebcs.set(Side.XMIN, lambda x, y: 0.0)
    ebcs.set(Side.XMAX, lambda x, y: 1.0)
    ebcs.set(Side.YMIN, ring_ana)
    ebcs.set(Side.YMAX, ring_ana)
    t0 = time.perf_counter()
    ring = SpcMap2d(PDE_RING_N, PDE_RING_N, quarter_ring(), ebcs,
                    NaturalBcs2d(), k=1.0, device="cuda")
    a = ring.solve_sps(0.0, lambda x, y: 0.0)
    rec.update(ring_n=PDE_RING_N, ring_wall_s=time.perf_counter() - t0,
               ring_max_error=max_error(ring, a, ring_ana))
    say("pde_path", part="spectral", **rec)
    if not (rec["spc2d_max_error"] <= PDE_SPC_ERR
            and rec["ring_max_error"] <= PDE_RING_ERR):
        raise AssertionError(f"pde_path spectral: {rec}")
    res["spectral"] = rec


def phase_pde_path():
    """Fdm2d, Spc2d and SpcMap2d on the card: Poisson at PDE_NPOINT^2
    through AUTO -> GRIDMF, at PDE_SPLU_NPOINT^2 through SPLU, and the
    spectral solvers. Kernel launches are counted from zero within each
    run and reported per run."""
    t0 = time.perf_counter()
    res = {}
    pde_gridmf(res)
    gc.collect()
    torch.cuda.empty_cache()
    pde_splu(res)
    gc.collect()
    torch.cuda.empty_cache()
    pde_spectral(res)
    res["wall_s"] = time.perf_counter() - t0
    say("pde_path", part="done", wall_s=res["wall_s"])
    return res


# -- nonlin_path ---------------------------------------------------------------

NONLIN_COUNTERS = ("n_steps", "n_accepted", "n_rejected", "n_function",
                   "n_jacobian", "n_factor", "n_lin_sol", "n_iteration_total")
# russell_tpu's CPU runs (f64) of the configurations below
BRATU_17_COUNTERS = (11, 11, 0, 40, 36, 36, 82, 40)
BRATU_17_STEP_L = (
    0.0, 0.4960955796883189, 1.2515741593031895, 2.279314040278554,
    3.562074739662457, 4.979582019300316, 6.241583538730863,
    6.801253135163321, 6.042066376691407, 4.545577772064729,
    2.6130363866949895, 1.0499269471279535)
BRATU_17_FOLD = 6.80217410        # the npoint-17 discrete fold
BRATU_1D_COUNTERS = (14, 14, 0, 40, 34, 34, 33, 40)
BSPLINE_COUNTERS = (62, 62, 0, 124, 63, 63, 62, 124)
BRATU_BIG = 257                   # ndim 65,025
BRATU_BK = 6.80812442259          # Bolstad & Keller's lambda_crit
# the discrete folds of russell_tpu's CPU runs (f64): arclength as
# tests/test_nonlin.py runs it, then its dense extended-system polish
BRATU_REF_FOLDS = {17: 6.80217409562718, 33: 6.806652729201835}
# |fold at BRATU_BIG - bratu_fold_expected(BRATU_BIG)|: the h^6 term left
# out of the fit is about 1e-9 there
BRATU_BIG_FOLD_TOL = 1e-7
BRATU_BIG_PROFILED_STEPS = 3


def bratu_fold_expected(npoint):
    """The 2-D Bratu FDM fold at ``npoint``: BRATU_BK less c h^2 - d h^4,
    with c and d fitted to BRATU_REF_FOLDS (h = 1 / (npoint - 1))."""
    (n1, f1), (n2, f2) = sorted(BRATU_REF_FOLDS.items())
    h1, h2 = 1.0 / (n1 - 1), 1.0 / (n2 - 1)
    c, d = np.linalg.solve([[h1 ** 2, -h1 ** 4], [h2 ** 2, -h2 ** 4]],
                           [BRATU_BK - f1, BRATU_BK - f2])
    h = 1.0 / (npoint - 1)
    return BRATU_BK - c * h ** 2 + d * h ** 4


def continuation(sample, args, method, stop, ddl, record=None,
                 callback=None, profile=False, **cfg):
    """One ``Solver.solve`` on the card from the sample's start: (u, status,
    counters tuple, Output, wall s, solver, mid, setup s, profile), the
    Output's step callback ``callback``. The sample and the Solver (its Gu
    analysis) are built first, their wall ``setup s``; with ``profile`` only the solve runs under the profiler
    (``kernel_device_ms``'s triple, else None)."""
    from russell_tpu_torch import nonlin
    t0 = time.perf_counter()
    system, u0, l0, *rest = getattr(nonlin.samples, sample)(*args)
    mid = rest[0] if rest and isinstance(rest[0], int) else None
    solver = nonlin.Solver(nonlin.Config(method=method, **cfg), system,
                           device="cuda")
    out = nonlin.Output().set_recording(record if record is not None
                                        else [mid])
    if callback is not None:
        out.set_step_callback(callback)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    got = []

    def run():
        got.append(solver.solve(u0, l0, nonlin.IniDir.POS, stop(mid), ddl,
                                output=out))

    prof = None
    t0 = time.perf_counter()
    if profile:
        prof = kernel_device_ms(run)
    else:
        run()
    wall = time.perf_counter() - t0
    u, _, status = got[0]
    st = solver.stats()
    return (u, status, tuple(getattr(st, k) for k in NONLIN_COUNTERS), out,
            wall, solver, mid, setup, prof)


def check_counters_nl(name, got, want):
    if tuple(got) != tuple(want):
        raise AssertionError(f"nonlin_path {name}: counters "
                             f"{dict(zip(NONLIN_COUNTERS, got))}, the "
                             f"reference's {dict(zip(NONLIN_COUNTERS, want))}")


def dense_gu(system):
    """(l, u) -> the system's Gu as a dense matrix on u's device."""
    n = system.ndim

    def gu(l, u):
        ii = torch.as_tensor(system.jac_ii, device=u.device)
        jj = torch.as_tensor(system.jac_jj, device=u.device)
        vals, _ = system.calc_jac(l, u, None)
        return torch.zeros((n, n), dtype=u.dtype, device=u.device).index_put(
            (ii, jj), vals, accumulate=True)
    return gu


def fold_polish(system, u, l, gu):
    """The fold of G by extended-system Newton in torch on u's device:
    [G; Gu v; v_k - 1] = 0 over z = (u, v, lambda), with ``gu(l, u)`` the
    dense Gu (``dense_gu``), as tests/test_nonlin.py polishes it in jax;
    returns lambda."""
    n = system.ndim
    w, vv = torch.linalg.eig(gu(l, u))
    v = vv[:, torch.argmin(w.abs())].real
    k = int(torch.argmax(v.abs()))
    z = torch.cat([u, v / v[k], torch.tensor([l], dtype=u.dtype,
                                             device=u.device)])

    def ff(z):
        uu, vv_, ll = z[:n], z[n:2 * n], z[2 * n]
        return torch.cat([system.calc_gg(ll, uu, None), gu(ll, uu) @ vv_,
                          (vv_[k] - 1.0)[None]])

    for _ in range(30):
        dz = torch.linalg.solve(torch.func.jacfwd(ff)(z), -ff(z))
        z = z + dz
        if float(dz.abs().max()) < 1e-11:
            break
    return float(z[2 * n])


def fold_polish_sparse(system, plan, u, l, max_iter=20):
    """The fold of G by the same extended-system Newton with Gu sparse, on
    u's device: each iteration factors Gu through ``factor`` on ``plan``
    (the system's Gu pattern, prepared on that device) and solves the
    (2n + 1) system by block elimination with four Gu solves (Keller's
    bordering), then once more on that solve's residual: Gu is near
    singular at the fold, and one step of refinement keeps the block
    elimination's error from steering u along Gu's null vector. The second
    derivatives (Gu v)_u x and (Gu v)_lambda are forward-mode products of
    Gu's entries (``torch.func.jvp``). The start v comes from inverse
    iteration on Gu. Returns (lambda, {"iterations", "last_dl", "last_du",
    "g_max", "guv_max"}), the last two the residuals at the fold."""
    from russell_tpu_torch.sparse import factor, ordering, splu
    dev = u.device
    n = system.ndim
    order, offsets = ordering.segment_index(system.jac_ii, n)
    order = None if order is None else torch.as_tensor(order, device=dev)
    offsets = torch.as_tensor(offsets, device=dev)
    jj = torch.as_tensor(system.jac_jj, device=dev)

    def times(vals, x):
        """Gu x for the Gu entries ``vals``."""
        return splu.segment_sum(vals * x[jj], order, offsets)

    def factored(ll, uu):
        vals, ggl = system.calc_jac(ll, uu, None)
        fac = factor.numeric_factorize(plan, vals)
        return (lambda b: factor.factor_solve(plan, fac, b)), vals, ggl

    l = torch.tensor(l, dtype=u.dtype, device=dev)
    solve, _, _ = factored(l, u)
    v = torch.ones_like(u)
    for _ in range(8):
        v = solve(v)
        v = v / v.abs().max()
    k = int(torch.argmax(v.abs()))
    v = v / v[k]
    info = {}
    for it in range(1, max_iter + 1):
        solve, vals, ggl = factored(l, u)

        def b_times(x, uu=u, ll=l, vv=v):
            """(Gu v)_u x: the entries' tangent along x, times v."""
            return times(torch.func.jvp(
                lambda w: system.calc_jac(ll, w, None)[0], (uu,), (x,))[1], vv)

        c_l = times(torch.func.jvp(
            lambda ll: system.calc_jac(ll, u, None)[0], (l,),
            (torch.ones_like(l),))[1], v)
        a2 = solve(ggl)
        b2 = solve(b_times(a2) - c_l)

        def block_solve(r1, r2, r3):
            """(du, dv, dl) with [Gu 0 G_l; B Gu C_l; 0 e_k 0] (du, dv, dl)
            = (r1, r2, r3)."""
            a1 = solve(r1)
            b1 = solve(r2 - b_times(a1))
            dl = (r3 - b1[k]) / b2[k]
            return a1 - dl * a2, b1 + dl * b2, dl

        r = (-system.calc_gg(l, u, None), -times(vals, v), 1.0 - v[k])
        du, dv, dl = block_solve(*r)
        cu, cv, cl = block_solve(
            r[0] - times(vals, du) - ggl * dl,
            r[1] - b_times(du) - times(vals, dv) - c_l * dl,
            r[2] - dv[k])
        du, dv, dl = du + cu, dv + cv, dl + cl
        u, v, l = u + du, v + dv, l + dl
        info = {"iterations": it, "last_dl": float(dl.abs()),
                "last_du": float(du.abs().max())}
        if info["last_dl"] < 1e-13:
            break
    vals, _ = system.calc_jac(l, u, None)
    info.update(g_max=float(system.calc_gg(l, u, None).abs().max()),
                guv_max=float(times(vals, v).abs().max()))
    return float(l), info


def phase_nonlin_path():
    """The continuation solvers on the card: the 2-D Bratu problem by
    arclength at npoint 17 (the reference's counters and steps, the fold
    polished in torch) and at BRATU_BIG with the default Config (AUTO's
    route, steps, walls, the busy share of the first steps, through the
    fold, the fold polished through ``factor`` and held to the h^2-h^4 fit
    of the reference's folds; a second run bit-identical), and natural
    continuation on the 1-D Bratu and the B-spline problems (the
    reference's counters)."""
    from russell_tpu_torch import nonlin
    t0_all = time.perf_counter()
    arc, nat = nonlin.Method.ARCLENGTH, nonlin.Method.NATURAL
    res = {}
    n17 = list(range(225))
    u, status, cnt, out, wall, solver, mid, _, _ = continuation(
        "bratu_2d_fdm", (17,), arc, lambda m: nonlin.Stop.max_comp_u(m, 6.0),
        nonlin.DeltaLambda.auto(0.5), record=n17)
    ls = np.asarray(out.step_l)
    j = int(np.argmax(ls))
    uj = torch.as_tensor(np.array([out.step_u(m)[j] for m in n17]),
                         device="cuda")
    system = solver.actual.system
    t0 = time.perf_counter()
    lam = fold_polish(system, uj, float(ls[j]), dense_gu(system))
    rec = {"route": solver.actual.ls.plan.genie.value, "status": status.name,
           "counters": dict(zip(NONLIN_COUNTERS, cnt)), "wall_s": wall,
           "step_l_max_abs_err": float(np.abs(ls - BRATU_17_STEP_L).max())
           if len(ls) == len(BRATU_17_STEP_L) else None,
           "fold_lambda": lam, "fold_err": abs(lam - BRATU_17_FOLD),
           "polish_s": time.perf_counter() - t0}
    say("nonlin_path", part="bratu_2d_17", **rec)
    check_counters_nl("bratu_2d_17", cnt, BRATU_17_COUNTERS)
    if not (status.success() and rec["step_l_max_abs_err"] is not None
            and rec["step_l_max_abs_err"] <= 1e-9 and rec["fold_err"] <= 1e-5):
        raise AssertionError(f"nonlin_path bratu_2d_17: {rec}")
    res["bratu_2d_17"] = rec

    top = {}

    def keep_top(stats, h, l, uu, args):
        if not top or l > top["l"]:
            top.update(l=l, u=uu.copy())
        return False

    runs = []
    for r in range(2):
        u, status, cnt, out, wall, solver, mid, setup, _ = continuation(
            "bratu_2d_fdm", (BRATU_BIG,), arc,
            lambda m: nonlin.Stop.max_comp_u(m, 6.0),
            nonlin.DeltaLambda.auto(0.5),
            callback=keep_top if r == 0 else None)
        runs.append((u, status, cnt, np.asarray(out.step_l),
                     np.asarray(out.step_u(mid)), wall, solver, setup))
    u, status, cnt, ls, umid, wall, solver, setup = runs[0]
    plan = solver.actual.ls.plan
    t0 = time.perf_counter()
    lam, polish = fold_polish_sparse(
        solver.actual.system, plan,
        torch.as_tensor(top["u"], device="cuda"), top["l"])
    polish_s = time.perf_counter() - t0
    # the busy share of the first BRATU_BIG_PROFILED_STEPS steps: the
    # sample and the Solver are built outside the profiled solve
    _, _, _, _, _, _, _, p_setup, (ms, p_wall, launches) = \
        continuation("bratu_2d_fdm", (BRATU_BIG,), arc,
                     lambda m: nonlin.Stop.steps(BRATU_BIG_PROFILED_STEPS),
                     nonlin.DeltaLambda.auto(0.5), profile=True)
    j = int(np.argmax(ls))
    expected = bratu_fold_expected(BRATU_BIG)
    rec = {"npoint": BRATU_BIG, "ndim": solver.ndim, "route": plan.genie.value,
           "block_k": plan.block_k, "nb": plan.nb, "bcr": plan.use_bcr,
           "tg_control_tol": solver.config.tg_control_tol,
           "status": status.name,
           "counters": dict(zip(NONLIN_COUNTERS, cnt)),
           "setup_s": [r[7] for r in runs], "wall_s": [r[5] for r in runs],
           "lambda_max": float(ls[j]),
           "u_mid_at_lambda_max": float(umid[j]), "u_mid_last": float(umid[-1]),
           "steps_recorded": len(ls),
           "fold_lambda": lam, "fold_expected": expected,
           "fold_err": abs(lam - expected), "polish": polish,
           "polish_s": polish_s,
           "fold_minus_lambda_max": lam - float(ls[j]),
           "profiled_steps": BRATU_BIG_PROFILED_STEPS,
           "profiled_setup_s": p_setup, "profiled_solve_wall_s": p_wall,
           "device_ms": sum(ms.values()), "device_launches": launches,
           "device_busy_share": sum(ms.values()) / (1e3 * p_wall),
           "top_kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])
                                  [:5]),
           "repeat_counters_equal": runs[1][2] == cnt,
           "repeat_bit_identical": bool(np.array_equal(runs[1][0], u)
                                        and np.array_equal(runs[1][3], ls))}
    say("nonlin_path", part=f"bratu_2d_{BRATU_BIG}", **rec)
    rises_then_falls = (0 < j < len(ls) - 1 and np.all(np.diff(ls[:j + 1]) > 0)
                        and ls[-1] < ls[j])
    if not (status.success() and rises_then_falls and umid[-1] >= 6.0
            and rec["fold_err"] <= BRATU_BIG_FOLD_TOL
            and ls[j] <= lam + 1e-9 and top["l"] == ls[j]
            and rec["repeat_counters_equal"] and rec["repeat_bit_identical"]):
        raise AssertionError(f"nonlin_path bratu_2d_{BRATU_BIG}: {rec}")
    res[f"bratu_2d_{BRATU_BIG}"] = rec
    del runs, solver
    gc.collect()
    torch.cuda.empty_cache()

    for name, sample, args, stop, ddl, want in (
            ("bratu_1d_natural", "bratu_1d_spc", (20,),
             lambda m: nonlin.Stop.max_lambda(3.4),
             nonlin.DeltaLambda.auto(0.5), BRATU_1D_COUNTERS),
            ("bspline_natural", "bspline_problem_1", (),
             lambda m: nonlin.Stop.max_lambda(1.0),
             nonlin.DeltaLambda.auto(0.01), BSPLINE_COUNTERS)):
        u, status, cnt, out, wall, solver, _, _, _ = continuation(
            sample, args, nat, stop, ddl, record=[0])
        rec = {"route": solver.actual.ls.plan.genie.value,
               "status": status.name,
               "counters": dict(zip(NONLIN_COUNTERS, cnt)), "wall_s": wall}
        say("nonlin_path", part=name, **rec)
        check_counters_nl(name, cnt, want)
        if not status.success():
            raise AssertionError(f"nonlin_path {name}: {rec}")
        res[name] = rec
    res["wall_s"] = time.perf_counter() - t0_all
    say("nonlin_path", part="done", wall_s=res["wall_s"],
        kernels="none: DENSE and BANDED run cuSOLVER/cuBLAS")
    return res


# -- 24. lab_path: core, math, dense and algo on the card ----------------------

LAB_N = 4096              # dense f64 (mat_mat_mul ... mat_eigen_sym)
LAB_N_HERM = 2048         # mat_eigen_herm (c128), mat_svd, pseudo-inverse
LAB_N_EIG = 1024          # mat_eigen (a batch of LAB_EIG_BATCH), gen_eigen
LAB_EIG_BATCH = 2
LAB_RES_TOL = 1e-12       # residuals relative to the norms of the operands
LAB_REPS = 3              # timed dense calls after the first (set-up) one
LAB_POINTS = 1 << 24      # special functions: 128 MiB an f64 tensor
LAB_ORACLE_STRIDE = 64    # every 64th point against scipy (2^18 points)
LAB_SLOW_STRIDE = 1024    # for jn/yn/in of order 50, whose scipy is slow
LAB_CPU_POINTS = 4096     # points of the port's CPU run
# the card against the CPU run where scipy is held more loosely
LAB_CPU_TOL = {"beta(b>=8)": 1e-13, "ln_beta(b>=8)": 1e-13}
JACOBI_PLAIN_N = (2, 8, 32)   # kernel against its plain version on the CPU
JACOBI_N = (128, 256)         # 128 runs the global-memory route
# the main path's launch at JACOBI_N[0] against the plain version on the
# CPU, run in a process of its own beside the rest of the phase
JACOBI_HELD_TIMEOUT_S = 600
NEWTON_N = (64, 2048)
# the reference's counters (russell_tpu on the CPU): RootFinder on x^4 - 1
# (chebyshev, refine) then brent on sin in [2, 4]: (n_function, n_jacobian,
# n_iterations); MinBracketing from 0 and MinSolver.brent on
# (x - 2)^2 + 1 + 0.1 sin 5x: (n_function, n_iterations) each; Quadrature
# of sqrt(1 - x^2) on [-1, 1]: (n_function, n_iterations)
LAB_ROOT_COUNTERS = (58, 0, 7)
LAB_MIN_COUNTERS = ((12, 10), (14, 14))
LAB_QUAD_COUNTERS = (1770, 30)


def lab_timed(fn):
    """(fn(), host wall s, device ms): one call between two CUDA events,
    ending in a synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def lab_check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"lab_path {name}: {err:.3e} > {tol:.1e}")
    return err


def lab_counters(name, got, want):
    if tuple(got) != tuple(want):
        raise AssertionError(f"lab_path {name}: counters {got}, the "
                             f"reference's {want}")


def inf_norm(x):
    x = np.asarray(x)
    return float(np.abs(x).sum(axis=-1).max()) if x.ndim > 1 else float(
        np.abs(x).max())


def lab_matrix(n, gen, dtype=torch.float64):
    """I + 0.1 G / sqrt(n), G seeded standard normal on the card: well
    conditioned, det finite."""
    g = torch.randn((n, n), generator=gen, dtype=dtype, device="cuda")
    return torch.eye(n, dtype=dtype, device="cuda") + (0.1 / n ** 0.5) * g


def lab_dense():
    """The dense surface at users' sizes, each result held on the host by
    its invariant against seeded vectors y (Freivalds): residuals relative
    to the operands' inf-norms <= LAB_RES_TOL. Each call's first run on
    its shapes is set-up (``first_wall_s``, ``first_device_ms``: cuSOLVER
    or MAGMA handles and workspaces); its time is the median of LAB_REPS
    calls after it, one at a time."""
    from russell_tpu_torch.core import Norm
    from russell_tpu_torch.dense import (
        mat_cholesky, mat_eigen, mat_eigen_herm, mat_eigen_sym, mat_gen_eigen,
        mat_inverse, mat_mat_mul, mat_norm, mat_pseudo_inverse, mat_svd,
        solve_lin_sys)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    out = {}
    n = LAB_N
    A, B = lab_matrix(n, gen), lab_matrix(n, gen)
    S = A @ A.mT
    Ah, Bh, Sh = A.cpu().numpy(), B.cpu().numpy(), S.cpu().numpy()
    y = rng.standard_normal(n)
    nA, nB, nS = inf_norm(Ah), inf_norm(Bh), inf_norm(Sh)
    lab_check("mat_norm", abs(float(mat_norm(A, Norm.INF)) - nA) / nA, 1e-14)

    def rec(name, fn, flops=None):
        res, first_wall, first_ms = lab_timed(fn)
        runs = [lab_timed(fn)[1:] for _ in range(LAB_REPS)]
        wall = statistics.median(r[0] for r in runs)
        dev_ms = statistics.median(r[1] for r in runs)
        r = {"wall_s": wall, "device_ms": dev_ms, "first_wall_s": first_wall,
             "first_device_ms": first_ms}
        if flops:
            r["gflops"] = flops / (dev_ms * 1e6)
        out[name] = r
        return res

    C = rec("mat_mat_mul", lambda: mat_mat_mul(1.0, A, B), 2.0 * n ** 3)
    out["mat_mat_mul"]["residual"] = lab_check(
        "mat_mat_mul", inf_norm(C.cpu().numpy() @ y - Ah @ (Bh @ y))
        / (nA * nB * inf_norm(y)), LAB_RES_TOL)
    L = rec("mat_cholesky", lambda: mat_cholesky(S), n ** 3 / 3.0)
    Lh = L.cpu().numpy()
    out["mat_cholesky"]["residual"] = lab_check(
        "mat_cholesky", inf_norm(Lh @ (Lh.T @ y) - Sh @ y)
        / (nS * inf_norm(y)), LAB_RES_TOL)
    b = torch.as_tensor(y, device="cuda")
    x = rec("solve_lin_sys", lambda: solve_lin_sys(A, b),
            2.0 * n ** 3 / 3.0 + 2.0 * n ** 2)
    xh = x.cpu().numpy()
    out["solve_lin_sys"]["residual"] = lab_check(
        "solve_lin_sys", inf_norm(Ah @ xh - y) / (nA * inf_norm(xh)),
        LAB_RES_TOL)
    inv, det = rec("mat_inverse", lambda: mat_inverse(A), 2.0 * n ** 3)
    ih = inv.cpu().numpy()
    sign, logdet = np.linalg.slogdet(Ah)
    out["mat_inverse"].update(
        residual=lab_check("mat_inverse", inf_norm(Ah @ (ih @ y) - y)
                           / (nA * inf_norm(ih) * inf_norm(y)), LAB_RES_TOL),
        det=float(det), det_rel_err=lab_check(
            "det", abs(float(det) - sign * np.exp(logdet))
            / abs(sign * np.exp(logdet)), 1e-10))
    del C, L, inv, x
    w, V = rec("mat_eigen_sym", lambda: mat_eigen_sym(S))
    wh, Vh = w.cpu().numpy(), V.cpu().numpy()
    out["mat_eigen_sym"].update(
        residual=lab_check("mat_eigen_sym", inf_norm(
            Sh @ (Vh @ y) - Vh @ (wh * y)) / (nS * inf_norm(Vh)
                                            * inf_norm(y)), LAB_RES_TOL),
        orthogonality=lab_check("mat_eigen_sym orthogonality", inf_norm(
            Vh.T @ (Vh @ y) - y) / inf_norm(y), 1e-12))
    del A, B, S, V, Ah, Bh, Sh, Vh
    torch.cuda.empty_cache()
    m = LAB_N_HERM
    G = lab_matrix(m, gen, torch.complex128)
    H = (G + G.mH) / 2
    Hh = H.cpu().numpy()
    yc = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    w, V = rec("mat_eigen_herm", lambda: mat_eigen_herm(H))
    wh, Vh = w.cpu().numpy(), V.cpu().numpy()
    out["mat_eigen_herm"]["residual"] = lab_check(
        "mat_eigen_herm", inf_norm(Hh @ (Vh @ yc) - Vh @ (wh * yc))
        / (inf_norm(Hh) * inf_norm(Vh) * inf_norm(yc)), LAB_RES_TOL)
    A2 = lab_matrix(m, gen)
    A2h = A2.cpu().numpy()
    y2 = y[:m]
    s, U, Vt = rec("mat_svd", lambda: mat_svd(A2))
    sh, Uh, Vth = s.cpu().numpy(), U.cpu().numpy(), Vt.cpu().numpy()
    out["mat_svd"]["residual"] = lab_check(
        "mat_svd", inf_norm(Uh @ (sh * (Vth @ y2)) - A2h @ y2)
        / (inf_norm(A2h) * inf_norm(y2)), LAB_RES_TOL)
    P = rec("mat_pseudo_inverse", lambda: mat_pseudo_inverse(A2))
    Ph = P.cpu().numpy()
    out["mat_pseudo_inverse"]["residual"] = lab_check(
        "mat_pseudo_inverse", inf_norm(A2h @ (Ph @ y2) - y2)
        / (inf_norm(A2h) * inf_norm(Ph) * inf_norm(y2)), LAB_RES_TOL)
    del G, H, V, A2, U, Vt, P
    torch.cuda.empty_cache()
    k = LAB_N_EIG
    Ab = torch.stack([lab_matrix(k, gen) for _ in range(LAB_EIG_BATCH)])
    Bg = lab_matrix(k, gen)
    yk = y[:k] + 0j

    def eig_residual(name, planes, a, bmat=None):
        lr, li, vr, vi = (t.cpu().numpy() for t in planes)
        lam, Vc = lr + 1j * li, vr + 1j * vi
        res = 0.0
        for i in range(lam.shape[0] if lam.ndim > 1 else 1):
            li_, Vi = (lam[i], Vc[i]) if lam.ndim > 1 else (lam, Vc)
            ai = a[i] if a.ndim > 2 else a
            rhs = Vi @ (li_ * yk)
            if bmat is not None:
                rhs = bmat @ rhs
            res = max(res, inf_norm(ai @ (Vi @ yk) - rhs) / (
                inf_norm(ai) * inf_norm(Vi) * inf_norm(yk)
                * (1.0 if bmat is None else inf_norm(bmat))))
        return lab_check(name, res, LAB_RES_TOL)

    planes = rec("mat_eigen_batched", lambda: mat_eigen(Ab))
    if not all(t.device == Ab.device for t in planes):
        raise AssertionError("mat_eigen: planes left the card")
    out["mat_eigen_batched"]["residual"] = eig_residual(
        "mat_eigen", planes, Ab.cpu().numpy())
    planes = rec("mat_gen_eigen", lambda: mat_gen_eigen(Ab[0], Bg))
    out["mat_gen_eigen"]["residual"] = eig_residual(
        "mat_gen_eigen", planes, Ab[0].cpu().numpy(), Bg.cpu().numpy())
    del Ab, Bg, planes
    torch.cuda.empty_cache()
    return out


def jacobi_work(n, sweeps):
    """(bytes, flops, barriers) of one decomposition: A read and V and w
    written once; per rotation 18 n + 13 flops (rows and columns of A and
    V: 6 flops an updated pair of entries; the rotation's scalars); two
    barriers a rotation."""
    rot = sweeps * n * (n - 1) // 2
    return 8 * (2 * n * n + n), rot * (18 * n + 13), 2 * rot + 1


def lab_sym(n, seed):
    if n == 2:
        return np.array([[2.0, 1.0], [1.0, 2.0]])  # equal diagonal
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def lab_jacobi():
    """jacobi_eig bit for bit against its plain version (run on the CPU)
    at JACOBI_PLAIN_N, and through the global-memory route at the largest;
    the plain version on the card once; then mat_eigen_sym_jacobi at
    JACOBI_N (the main window: its launches), eigenvalues within
    LAB_RES_TOL ||A|| of torch.linalg.eigh, |A V - V w| within
    LAB_RES_TOL ||A|| and |V^T V - I| within LAB_RES_TOL, with the kernel's
    time, the bound and eigh's time at each n. Returns the record and the
    main window's (w, V) on the host, by n."""
    from russell_tpu_torch.dense import mat_eigen_sym_jacobi, matrix_ops
    sweeps = matrix_ops.JACOBI_SWEEPS
    held = []
    for n in JACOBI_PLAIN_N:
        a = lab_sym(n, n)
        t0 = time.perf_counter()
        wp, Vp = matrix_ops._jacobi_eig_plain(torch.as_tensor(a), sweeps)
        plain_cpu = (wp, Vp)
        plain_cpu_s = time.perf_counter() - t0
        ac = torch.as_tensor(a, device="cuda")
        routes = [None] + ([16] if n == JACOBI_PLAIN_N[-1] else [])
        for budget in routes:
            default = matrix_ops.JACOBI_SMEM_BYTES
            try:
                if budget is not None:
                    matrix_ops.JACOBI_SMEM_BYTES = budget
                w, V = matrix_ops.jacobi_eig(ac)
                w.cpu()
            finally:
                matrix_ops.JACOBI_SMEM_BYTES = default
            if not (torch.equal(w.cpu(), wp) and torch.equal(V.cpu(), Vp)):
                raise AssertionError(f"jacobi_eig n {n}: not the plain "
                                     "version's bits")
            held.append({"n": n, "route": "shared" if budget is None
                         else "global", "bit_identical": True,
                         "max_abs_err": max(
                             float((w.cpu() - wp).abs().max()),
                             float((V.cpu() - Vp).abs().max())),
                         "plain_cpu_s": plain_cpu_s})
    n = JACOBI_PLAIN_N[-1]
    a = torch.as_tensor(lab_sym(n, n), device="cuda")
    (wpc, Vpc), _, plain_ms = lab_timed(
        lambda: matrix_ops._jacobi_eig_plain(a, sweeps))
    if not (torch.equal(wpc.cpu(), plain_cpu[0])
            and torch.equal(Vpc.cpu(), plain_cpu[1])):
        raise AssertionError("jacobi_eig's plain version: other bits on the "
                             "card than on the CPU")
    nb, fl, barriers = jacobi_work(n, sweeps)
    bms, by = bound(nb, fl)
    small = {"n": n, "ms": time_ms(lambda: matrix_ops.jacobi_eig(a), reps=5),
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "barriers": barriers,
             "library_ms": time_ms(lambda: torch.linalg.eigh(a), reps=5)}
    mats = {n: torch.as_tensor(lab_sym(n, n), device="cuda")
            for n in JACOBI_N}
    matrix_ops.reset_launch_counts()
    outs = {n: mat_eigen_sym_jacobi(mats[n]) for n in JACOBI_N}
    outs = {n: (w.cpu(), V.cpu()) for n, (w, V) in outs.items()}
    launches = matrix_ops.jacobi_eig.launches
    if launches != len(JACOBI_N):
        raise AssertionError(f"jacobi_eig: {launches} launches on the path")
    at_n = {}
    for n in JACOBI_N:
        w, V = (t.cuda() for t in outs[n])
        we = torch.linalg.eigvalsh(mats[n])
        scale = float(torch.linalg.matrix_norm(mats[n], 2))
        err = lab_check(f"jacobi n {n}",
                        float((w - we).abs().max()) / scale, LAB_RES_TOL)
        resid = lab_check(f"jacobi n {n} |A V - V w|", float(
            (mats[n] @ V - V * w).abs().max()) / scale, LAB_RES_TOL)
        orth = lab_check(f"jacobi n {n} |V^T V - I|", float(
            (V.mT @ V - torch.eye(n, dtype=V.dtype, device=V.device))
            .abs().max()), LAB_RES_TOL)
        nb, fl, barriers = jacobi_work(n, sweeps)
        bms, by = bound(nb, fl)
        kms = statistics.median(lab_timed(
            lambda: matrix_ops.jacobi_eig(mats[n]))[2] for _ in range(3))
        at_n[n] = {"route": "shared" if 16 * n * (n + 1)
                   <= matrix_ops.JACOBI_SMEM_BYTES else "global",
                   "ms": kms, "bound_ms": bms, "bound_by": by,
                   "barriers": barriers, "ns_per_barrier": 1e6 * kms
                   / barriers, "eig_max_rel_err": err,
                   "residual": resid, "orthogonality": orth,
                   "library_ms": time_ms(lambda: torch.linalg.eigh(mats[n]),
                                         reps=5)}
    return {"held_to_plain": held, "launches": launches, "small": small,
            "at_n": at_n}, outs


def jacobi_plain_sorted(n, sweeps):
    """(w, V, seconds): the plain version of jacobi_eig on the CPU (one
    thread) on lab_sym(n, n), sorted as mat_eigen_sym_jacobi sorts. The
    phase runs it in a process of its own, beside its other work."""
    from russell_tpu_torch.dense import matrix_ops
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    w, V = matrix_ops._jacobi_eig_plain(torch.as_tensor(lab_sym(n, n)),
                                        sweeps)
    order = torch.argsort(w, stable=True)
    return w[order], V[:, order], time.perf_counter() - t0


def jacobi_main_held(plain, outs):
    """The main window's launch at JACOBI_N[0] against ``plain`` (the
    pending jacobi_plain_sorted), bit for bit; a held_to_plain record."""
    t0 = time.perf_counter()
    wp, Vp, plain_cpu_s = plain.get(timeout=JACOBI_HELD_TIMEOUT_S)
    waited_s = time.perf_counter() - t0
    n = JACOBI_N[0]
    w, V = outs[n]
    if not (torch.equal(w, wp) and torch.equal(V, Vp)):
        raise AssertionError(f"mat_eigen_sym_jacobi n {n} (the main path's "
                             "launch): not the plain version's bits")
    return {"n": n, "route": "global", "main_path": True,
            "bit_identical": True, "max_abs_err": max(
                float((w - wp).abs().max()), float((V - Vp).abs().max())),
            "plain_cpu_s": plain_cpu_s, "waited_s": waited_s}


def lab_inputs(edges, lo, hi, seed):
    """LAB_POINTS f64 inputs: ``edges`` first, then seeded uniform draws
    in [lo, hi), made on the host."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, LAB_POINTS)
    x[:len(edges)] = edges
    return x


BESSEL_EDGES = (0.0, 1.0, -1.0, -3.0, -8.0, -17.0, -26.0, 8.0, 17.0, 26.0,
                np.nextafter(8.0, 0), np.nextafter(8.0, 9),
                np.nextafter(17.0, 0), np.nextafter(17.0, 18),
                np.nextafter(26.0, 0), np.nextafter(26.0, 27), 200.0)


def lab_special_specs():
    """(name, port call on the inputs, scipy oracle on the host inputs,
    inputs (name: (edges, lo, hi)), tolerance kind, tolerance, stride):
    every elementwise public function of ``math``, at the tolerances of
    tests/test_math.py ("abs": |d| <= tol; "rel1": |d| <= tol max(|w|, 1);
    "rel": |d| <= tol |w|)."""
    from russell_tpu_torch import math as pm
    from scipy import special as ss
    pos = ((0.0, 1.0, 8.0, 17.0, 26.0, 200.0), 1e-6, 200.0)
    jx = (BESSEL_EDGES, -200.0, 200.0)
    ix = ((0.0, 1.0, -1.0, 30.0, -30.0), -30.0, 30.0)
    kx = ((0.0, -1.0, 1.0, 2.0, 60.0), 1e-5, 60.0)
    unit = ((-1.0, 0.0, 1.0), -1.0, 1.0)

    def ynan(w, x):
        """scipy's Y at x < 0 is NaN by the reference's contract too."""
        w[x < 0] = np.nan
        return w

    def gamma_ref(x):
        w = ss.gamma(x)
        w[(x <= 0) & (x == np.floor(x))] = np.nan
        return w

    def pi_ref(n, phi, m):
        s, c = np.sin(phi), np.cos(phi)
        return s * ss.elliprf(c * c, 1 - m * s * s, 1.0) + n * s ** 3 / 3 \
            * ss.elliprj(c * c, 1 - m * s * s, 1.0, 1 - n * s * s)

    def cheb(kind, n, d):
        # T_n, or U_n = sum of 2 T_j over j = n, n-2, ... (T_0 once), as a
        # Chebyshev series: numpy differentiates and sums it by Clenshaw
        c = np.zeros(n + 1)
        if kind == "T":
            c[n] = 1.0
        else:
            c[n % 2::2] = 2.0
            c[0] = 1.0 if n % 2 == 0 else 0.0
        cc = np.polynomial.chebyshev.chebder(c, d) if d else c
        return lambda x: np.polynomial.chebyshev.chebval(x, cc)

    def leg(n, d):
        c = np.zeros(n + 1)
        c[n] = 1.0
        cc = np.polynomial.legendre.legder(c, d) if d else c
        return lambda x: np.polynomial.legendre.legval(x, cc)

    S = LAB_ORACLE_STRIDE
    specs = [
        ("bessel_j0", pm.bessel_j0, ss.j0, {"x": jx}, "abs", 2e-15, S),
        ("bessel_j1", pm.bessel_j1, ss.j1, {"x": jx}, "abs", 2e-15, S),
        # Y0/Y1: test_math.py's 2e-14 absolute where |Y| <= 1 and relative
        # above (near 0, where -2/(pi x) dominates, an ulp of CUDA's log
        # moves the sum's rounding by an ulp of |Y|)
        ("bessel_y0", pm.bessel_y0, lambda x: ynan(ss.y0(x), x), {"x": jx},
         "rel1", 2e-14, S),
        ("bessel_y1", pm.bessel_y1, lambda x: ynan(ss.y1(x), x), {"x": jx},
         "rel1", 2e-14, S),
        ("bessel_jn(20)", lambda x: pm.bessel_jn(20, x),
         lambda x: ss.jv(20, x), {"x": jx}, "rel1", 1e-14, S),
        ("bessel_jn(50)", lambda x: pm.bessel_jn(50, x),
         lambda x: ss.jv(50, x), {"x": jx}, "rel1", 1e-14, LAB_SLOW_STRIDE),
        ("bessel_yn(20)", lambda x: pm.bessel_yn(20, x),
         lambda x: ynan(ss.yn(20, x), x), {"x": pos}, "rel1", 1e-13, S),
        ("bessel_i0", pm.bessel_i0, ss.i0, {"x": ix}, "rel1", 1e-13, S),
        ("bessel_i1", pm.bessel_i1, ss.i1, {"x": ix}, "rel1", 1e-13, S),
        ("bessel_in(5)", lambda x: pm.bessel_in(5, x),
         lambda x: ss.iv(5, x), {"x": ix}, "rel1", 1e-13, S),
        ("bessel_in(50)", lambda x: pm.bessel_in(50, x),
         lambda x: ss.iv(50, x), {"x": ix}, "rel1", 1e-13, LAB_SLOW_STRIDE),
        ("bessel_k0", pm.bessel_k0, ss.k0, {"x": kx}, "rel", 1e-13, S),
        ("bessel_k1", pm.bessel_k1, ss.k1, {"x": kx}, "rel", 1e-13, S),
        ("bessel_kn(10)", lambda x: pm.bessel_kn(10, x),
         lambda x: ss.kn(10, x), {"x": kx}, "rel", 1e-13, S),
        ("gamma", pm.gamma, gamma_ref,
         {"x": ((0.0, -1.0, -2.0, -7.0, 1.0, 0.5, -0.5, -2.5), -10.0, 40.0)},
         "rel", 1e-13, S),
        ("ln_gamma", pm.ln_gamma, ss.gammaln,
         {"x": ((0.5, 1.0, 2.0, 3.7), 0.01, 100.0)}, "rel1", 1e-13, S),
        ("beta", pm.beta, ss.beta, {"a": ((2.0, 0.5), 0.1, 7.9),
                                    "b": ((3.0, 0.5), 0.1, 7.9)},
         "rel", 1e-13, S),
        ("ln_beta", pm.ln_beta, ss.betaln, {"a": ((2.0,), 0.1, 7.9),
                                            "b": ((3.0,), 0.1, 7.9)},
         "rel1", 1e-13, S),
        # max(a, b) >= 8 and large arguments: the reference's algdiv (jax's
        # copy of cdflib's, ROADMAP.md section 3) is up to 6.4e-7 of
        # max(|ln B|, 1) off scipy's betaln, so 1.4e-6 relative in B; the
        # CPU run is held at 1e-13 (LAB_CPU_TOL)
        ("beta(b>=8)", pm.beta, ss.beta,
         {"a": ((0.5, 3.0, 30.0, 1e3, 1e6), 0.1, 30.0),
          "b": ((8.0, 9.0, 1e2, 1e5, 1e7), 8.0, 1e3)}, "rel", 2e-6, S),
        ("ln_beta(b>=8)", pm.ln_beta, ss.betaln,
         {"a": ((0.5, 3.0, 30.0, 1e3, 1e6), 0.1, 1e4),
          "b": ((8.0, 9.0, 1e2, 1e5, 1e7), 8.0, 1e6)}, "rel1", 1e-6, S),
        ("erf", pm.erf, ss.erf, {"x": ((0.0, 1.0, -1.0), -6.0, 6.0)},
         "abs", 1e-14, S),
        ("erfc", pm.erfc, ss.erfc, {"x": ((0.0, 1.0, -1.0), -6.0, 6.0)},
         "abs", 1e-14, S),
        ("erf_inv", pm.erf_inv, ss.erfinv,
         {"x": ((1.0, -1.0, 0.0, 1.5, -2.0), -0.999, 0.999)}, "rel", 1e-9,
         S),
        ("erfc_inv", pm.erfc_inv, ss.erfcinv,
         {"x": ((0.0, 1.0, 2.0), 0.001, 1.999)}, "rel", 1e-9, S),
        ("logistic", pm.logistic, ss.expit, {"x": ((0.0,), -30.0, 30.0)},
         "abs", 1e-15, S),
        ("logistic_deriv1", pm.logistic_deriv1,
         lambda x: ss.expit(x) * (1 - ss.expit(x)),
         {"x": ((0.0,), -30.0, 30.0)}, "abs", 1e-15, S),
        ("sign", pm.sign, np.sign, {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)},
         "abs", 0.0, S),
        ("ramp", pm.ramp, lambda x: np.maximum(x, 0.0),
         {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("heaviside", pm.heaviside, lambda x: np.heaviside(x, 0.5),
         {"x": ((0.0, -1.0, 1.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("boxcar", lambda x: pm.boxcar(x, -1.0, 2.0),
         lambda x: np.heaviside(x + 1.0, 0.5) - np.heaviside(x - 2.0, 0.5),
         {"x": ((-1.0, 2.0, 0.0), -5.0, 5.0)}, "abs", 0.0, S),
        ("smooth_ramp", lambda x: pm.smooth_ramp(x, 2.0),
         lambda x: np.where(-2 * x > 500, 0.0, x + np.log1p(np.exp(-2 * x))
                            / 2), {"x": ((0.0, -300.0, 300.0), -20.0, 20.0)},
         "rel1", 1e-14, S),
        ("smooth_ramp_deriv1", lambda x: pm.smooth_ramp_deriv1(x, 2.0),
         lambda x: ss.expit(2 * x), {"x": ((0.0, 300.0), -20.0, 20.0)},
         "abs", 1e-15, S),
        ("smooth_ramp_deriv2", lambda x: pm.smooth_ramp_deriv2(x, 2.0),
         lambda x: 2 * ss.expit(2 * x) * ss.expit(-2 * x),
         {"x": ((0.0, 300.0), -20.0, 20.0)}, "abs", 1e-14, S),
        ("suq_sin", lambda x: pm.suq_sin(x, 2.5),
         lambda x: np.sign(np.sin(x)) * np.abs(np.sin(x)) ** 2.5,
         {"x": ((0.0,), -10.0, 10.0)}, "abs", 1e-14, S),
        ("suq_cos", lambda x: pm.suq_cos(x, 2.5),
         lambda x: np.sign(np.cos(x)) * np.abs(np.cos(x)) ** 2.5,
         {"x": ((0.0,), -10.0, 10.0)}, "abs", 1e-14, S),
        ("modulo", lambda x: pm.modulo(x, 1.5), lambda x: np.fmod(x, 1.5),
         {"x": ((-5.5, 5.5, 0.0), -100.0, 100.0)}, "abs", 0.0, S),
        ("neg_one_pow_n", lambda x: pm.neg_one_pow_n(torch.round(x)),
         lambda x: np.where(np.round(x) % 2 == 0, 1.0, -1.0),
         {"x": ((0.0, 1.0, -3.0), -1000.0, 1000.0)}, "abs", 0.0, S),
        ("elliptic_f", pm.elliptic_f, ss.ellipkinc,
         {"phi": ((np.pi / 2, 0.0, 1.0), 0.0, np.pi / 2),
          "m": ((1.0, 0.5, 0.9), 0.0, 0.999)}, "rel", 1e-13, S),
        ("elliptic_e", pm.elliptic_e, ss.ellipeinc,
         {"phi": ((np.pi / 2, 0.0, 1.0), 0.0, np.pi / 2),
          "m": ((1.0, 0.5, 0.9), 0.0, 1.0)}, "rel", 1e-13, S),
        ("elliptic_pi", pm.elliptic_pi, pi_ref,
         {"n": ((0.3, -0.5, 0.0), -1.0, 0.9),
          "phi": ((1.0, 0.7, np.pi / 2), 0.0, np.pi / 2),
          "m": ((0.5, 0.9, 0.0), 0.0, 0.999)}, "rel", 1e-13, S),
        ("carlson_rf", pm.carlson_rf, ss.elliprf,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0)}, "rel", 1e-13, S),
        ("carlson_rd", pm.carlson_rd, ss.elliprd,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0)}, "rel", 1e-13, S),
        ("carlson_rj", pm.carlson_rj, ss.elliprj,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0),
          "z": ((2.0,), 0.01, 3.0), "p": ((0.5,), 0.01, 3.0)}, "rel", 1e-13,
         S),
        ("carlson_rc", pm.carlson_rc, ss.elliprc,
         {"x": ((0.0,), 0.0, 3.0), "y": ((1.0,), 0.01, 3.0)}, "rel", 1e-13,
         S),
    ]
    # the derivatives away from |x| = 1: the reference's formulas divide by
    # 1 - x^2 (its ODEs), losing digits as |x| -> 1 (1e-4 absolute for
    # U5'' at 1 - |x| = 3e-6), and take the limits at +-1 exactly
    inner = ((-1.0, 0.0, 1.0), -0.99, 0.99)
    for n in (5, 10):
        for d, suf in ((0, ""), (1, "_deriv1"), (2, "_deriv2")):
            tol = (1e-12, 1e-10, 1e-9)[d]
            dom = {"x": unit if d == 0 else inner}
            specs.append((f"chebyshev_tn{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"chebyshev_tn{suf}"), n),
                          cheb("T", n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
            specs.append((f"chebyshev_un{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"chebyshev_un{suf}"), n),
                          cheb("U", n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
            specs.append((f"legendre_pn{suf}({n})",
                          (lambda f, n: lambda x: f(n, x))(
                              getattr(pm, f"legendre_pn{suf}"), n),
                          leg(n, d), dom, "abs",
                          tol * n ** (2 * d) / 25 ** d, S))
    return specs


def lab_compare(kind, got, want, tol):
    """Largest deviation under ``kind``; NaN and inf must sit where the
    oracle has them."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN where the oracle has none, or none where "
                             "it has one")
    fin = np.isfinite(want)
    if not np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)]):
        raise AssertionError("infinities differ")
    d = np.abs(got[fin] - want[fin])
    if kind == "rel1":
        d = d / np.maximum(np.abs(want[fin]), 1.0)
    elif kind == "rel":
        d = d / np.maximum(np.abs(want[fin]), 1e-300)
    err = float(d.max()) if d.size else 0.0
    return lab_check(kind, err, tol)


def lab_special():
    """Every elementwise public function of ``math`` on LAB_POINTS seeded
    points on the card (edge values first): the finite share, every
    stride-th point and all edges against scipy on the host, the first
    LAB_CPU_POINTS against the port's CPU run; points/s and device launches
    of one call of bessel_jn(50), bessel_in(50) and elliptic_pi."""
    out, failed = {}, []
    specs = lab_special_specs()
    for i, (name, fn, ref, ins, kind, tol, stride) in enumerate(specs):
        host = [lab_inputs(e, lo, hi, SEED + 17 * i + j)
                for j, (e, lo, hi) in enumerate(ins.values())]
        dev = [torch.as_tensor(h, device="cuda") for h in host]
        got, wall, dev_ms = lab_timed(lambda: fn(*dev))
        if got.shape != (LAB_POINTS,) or got.device != dev[0].device:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} on "
                                 f"{got.device}")
        n_edges = max(len(e) for e, _, _ in ins.values())
        idx = np.unique(np.concatenate([np.arange(n_edges),
                                        np.arange(0, LAB_POINTS, stride)]))
        sub = got[torch.as_tensor(idx, device="cuda")].cpu().numpy()
        cpu = fn(*(torch.as_tensor(h[:LAB_CPU_POINTS]) for h in host))
        err = cpu_err = None
        try:
            err = lab_compare(kind, sub, ref(*(h[idx] for h in host)), tol)
            # the card against the CPU at the same bound (or LAB_CPU_TOL):
            # their sin, cos, log and exp differ in the last bits
            cpu_err = lab_compare(kind, got[:LAB_CPU_POINTS].cpu().numpy(),
                                  cpu.numpy(), LAB_CPU_TOL.get(name, tol))
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        out[name] = {"max_err": err, "kind": kind, "tol": tol,
                     "checked": len(idx), "cpu_max_err": cpu_err,
                     "finite_share": float(torch.isfinite(got).double()
                                           .mean()),
                     "device_ms": dev_ms, "wall_s": wall}
        del dev, got
    if failed:
        raise AssertionError("lab_path special functions: "
                             + "; ".join(failed))
    for name in ("bessel_jn(50)", "bessel_in(50)", "elliptic_pi"):
        spec = next(s for s in specs if s[0] == name)
        dev = [torch.as_tensor(lab_inputs(e, lo, hi, SEED), device="cuda")
               for e, lo, hi in spec[3].values()]
        ms_by, wall, launches = kernel_device_ms(lambda: spec[1](*dev))
        dms = sum(ms_by.values())
        out[name].update(launches_a_call=launches, profiled_device_ms=dms,
                         points_per_s=LAB_POINTS / (out[name]["device_ms"]
                                                    / 1e3),
                         device_points_per_s=LAB_POINTS / (dms / 1e3),
                         busy=dms / (wall * 1e3))
    torch.cuda.empty_cache()
    return out


def lab_algo():
    """NewtonSolver on A u + u^3 - b (A SPD) on the card: at n 64 its
    counters and u against the CPU run, at n 2048 u against a numpy Newton
    oracle; InterpChebyshev.adapt_function then eval on LAB_POINTS points
    against its CPU eval; RootFinder, MinSolver and Quadrature (host work)
    against the reference's counters."""
    import math as pymath
    from russell_tpu_torch import algo
    out = {}
    for n in NEWTON_N:
        rng = np.random.default_rng(n)
        g = rng.standard_normal((n, n))
        a = g @ g.T / n + np.eye(n)
        b = rng.standard_normal(n)

        def run(dev):
            A, B = torch.as_tensor(a, device=dev), torch.as_tensor(b,
                                                                  device=dev)
            solver = algo.NewtonSolver(n)
            u = solver.solve(np.zeros(n), lambda x, u, _: A @ u + u ** 3 - B,
                             device=dev)
            st = solver.stats
            return u, (st.n_function, st.n_jacobian, st.n_iterations)

        (u, cnt), wall, dev_ms = lab_timed(lambda: run("cuda"))
        if u.device.type != "cuda":
            raise AssertionError("NewtonSolver: u left the card")
        rec = {"counters": cnt, "wall_s": wall, "device_ms": dev_ms}
        if n == NEWTON_N[0]:
            uc, cc = run("cpu")
            if cc != cnt:
                raise AssertionError(f"NewtonSolver n {n}: counters {cnt} "
                                     f"on the card, {cc} on the CPU")
            rec["u_max_abs_diff_cpu"] = lab_check(
                "newton cpu", float((u.cpu() - uc).abs().max()), 1e-12)
        else:
            v, its = np.zeros(n), 0
            while True:
                its += 1
                r = a @ v + v ** 3 - b
                if np.sqrt(np.sum((r / (1e-10 + 1e-10 * np.abs(v))) ** 2)
                           / n) < 1:
                    break
                v = v + np.linalg.solve(a + np.diag(3 * v * v), -r)
            rec["oracle_iterations"] = its
            rec["u_max_abs_diff_oracle"] = lab_check(
                "newton oracle", float(np.abs(u.cpu().numpy() - v).max()),
                1e-10)
        out[f"newton_{n}"] = rec
    f = lambda x, _: pymath.cos(3.0 * x) * pymath.exp(-0.1 * x)  # noqa: E731
    interp = algo.InterpChebyshev(200, 0.0, 20.0)
    t0 = time.perf_counter()
    interp.adapt_function(1e-10, f)
    adapt_s = time.perf_counter() - t0
    xs = torch.as_tensor(lab_inputs((0.0, 20.0, -1.0, 21.0), 0.0, 20.0,
                                    SEED), device="cuda")
    got, wall, dev_ms = lab_timed(lambda: interp.eval(xs))
    want = interp.eval(xs.cpu())
    out["interp_chebyshev"] = {
        "degree": interp.get_degree(), "adapt_s": adapt_s,
        "eval_device_ms": dev_ms, "eval_wall_s": wall,
        "points_per_s": LAB_POINTS / (dev_ms / 1e3) if dev_ms else None,
        "max_abs_diff_cpu": lab_check("interp eval", float(
            (got.cpu() - want).abs().max()), 1e-13),
        "max_abs_err_f": lab_check("interp f", float(np.abs(
            got[:4096].cpu().numpy() - np.array([f(x, None) for x in xs[:4096]
                                                 .cpu().numpy().clip(0, 20)])
        ).max()), 1e-9)}
    g4 = lambda x, a: x ** 4 - 1.0  # noqa: E731
    solver = algo.RootFinder().set_enable_stats(True)
    t0 = time.perf_counter()
    roots = solver.chebyshev(algo.InterpChebyshev(2, -2.0, 2.0)
                             .set_function(2, g4))
    solver.refine(roots, -2.0, 2.0, g4)
    root = solver.brent(2.0, 4.0, lambda x, a: pymath.sin(x))
    st = solver.stats
    cnt = (st.n_function, st.n_jacobian, st.n_iterations)
    lab_counters("RootFinder", cnt, LAB_ROOT_COUNTERS)
    out["root_finder"] = {"counters": cnt, "roots": roots, "brent": root,
                          "host_s": time.perf_counter() - t0}
    h = lambda x, a: (x - 2.0) ** 2 + 1.0 + 0.1 * pymath.sin(5 * x)  # noqa
    br = algo.MinBracketing().set_enable_stats(True)
    bk = br.basic(0.0, h)
    ms = algo.MinSolver().set_enable_stats(True)
    xmin = ms.brent(bk.a, bk.c, h)
    cnt = ((br.stats.n_function, br.stats.n_iterations),
           (ms.stats.n_function, ms.stats.n_iterations))
    lab_counters("MinSolver", cnt, LAB_MIN_COUNTERS)
    out["min_solver"] = {"counters": cnt, "x_min": xmin}
    q = algo.Quadrature().set_enable_stats(True)
    v = q.integrate(-1.0, 1.0, lambda x, a: pymath.sqrt(1.0 - x * x))
    cnt = (q.stats.n_function, q.stats.n_iterations)
    lab_counters("Quadrature", cnt, LAB_QUAD_COUNTERS)
    out["quadrature"] = {"counters": cnt, "value": v,
                         "err": lab_check("quadrature", abs(v - pymath.pi
                                                            / 2), 1e-9)}
    return out


def phase_lab_path():
    """Phase 24: core, math, dense and algo at the sizes their users run
    (the module docstring's item 24). Returns the records; the kernels line
    takes the Jacobi one. The plain version of the main window's first
    ``jacobi_eig`` launch runs on the CPU in a process of its own from the
    start, and is held to that launch at the end."""
    import multiprocessing
    from russell_tpu_torch.dense import matrix_ops
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        plain = pool.apply_async(jacobi_plain_sorted,
                                 (JACOBI_N[0], matrix_ops.JACOBI_SWEEPS))
        res = {"dense": lab_dense()}
        say("lab_path", part="dense", **res["dense"])
        res["jacobi"], outs = lab_jacobi()
        say("lab_path", part="jacobi",
            **{k: v for k, v in res["jacobi"].items() if k != "at_n"},
            at_n={str(k): v for k, v in res["jacobi"]["at_n"].items()})
        res["special"] = lab_special()
        say("lab_path", part="special", functions=res["special"])
        res["algo"] = lab_algo()
        say("lab_path", part="algo", **res["algo"])
        held = jacobi_main_held(plain, outs)
    res["jacobi"]["held_to_plain"].append(held)
    say("lab_path", part="jacobi_main_held", **held)
    say("lab_path", part="done", wall_s=time.perf_counter() - t0)
    return res


def jacobi_entry(lres):
    """The kernels line's jacobi_eig entry: at the largest n held bit for
    bit (time, plain version's time, bound, eigh's time), and at JACOBI_N."""
    j = lres["jacobi"]
    s = j["small"]
    return {"name": "jacobi_eig", "route": "cuda",
            "source": "russell_tpu_torch/csrc/jacobi_eig.cu",
            "replaces": "russell_tpu/dense/matrix_ops.py:148 (plain XLA)",
            "launches": j["launches"],
            "max_abs_err": max(h["max_abs_err"] for h in j["held_to_plain"]),
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "barriers": s["barriers"],
            "held_to_plain": j["held_to_plain"],
            "at_n": {str(k): v for k, v in j["at_n"].items()},
            "shapes": f"n {s['n']} (held bit for bit; plain_ms one call of "
                      "the plain version on the card); at_n: the "
                      "lab_path's mat_eigen_sym_jacobi calls"}


def pde_entry(pres, name):
    """A kernel's launches in pde_path: per GRIDMF factorization at
    PDE_NPOINT (gj_inv only, with the held-to-plain record of one such
    factorization), over a SPLU solve_sps at PDE_SPLU_NPOINT and the
    held-to-plain record of the second one."""
    g = pres[f"gridmf_{PDE_NPOINT}"]
    sp = pres[f"splu_{PDE_SPLU_NPOINT}"]
    out = {}
    if name == "gj_inv":
        out.update(gridmf_launches_per_factorization=g[
            "launches_cold_factorization"]["gj_inv"],
            gridmf_ms_per_factorization=g["gj_inv_device_ms"],
            gridmf_held_to_plain=g["held_to_plain"]["gj_inv"])
    out.update(splu_launches_solve_sps=sp["launches_solve_sps"][name],
               splu_held_to_plain=sp["held_to_plain"][name])
    return out


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
    pres = phase_pde_path()
    phase_nonlin_path()
    labres = phase_lab_path()
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
            "pde_path": pde_entry(pres, name),
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
        "pde_path": pde_entry(pres, "gj_inv"),
        "shapes": f"the base calls of one npoint-{NPOINT} GRIDMF factorize "
                  "pair, summed (inv_block: per factorize pair, the "
                  "top-level pivot blocks)"})
    kernels.append(jacobi_entry(labres))
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
    elif "--pde-nonlin" in sys.argv:
        phase_device()
        phase_build()
        phase_pde_path()
        phase_nonlin_path()
    elif "--lab" in sys.argv:
        phase_device()
        phase_build()
        lab_kernels = [jacobi_entry(phase_lab_path())]
        print(json.dumps({"kernels": lab_kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    elif "--ab" in sys.argv:
        i = sys.argv.index("--ab")
        main_ab(sys.argv[i + 1],
                int(sys.argv[i + 2]) if len(sys.argv) > i + 2 else 1)
    else:
        main()
