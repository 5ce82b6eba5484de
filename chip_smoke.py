#!/usr/bin/env python3
"""Smoke run of russell_tpu_torch on one NVIDIA GPU.

Drives the port's two paths and checks them. The main path is Radau5 on
the 2-D Brusselator PDE through the SPLU solver, whose factorize rows run
the CUDA kernels ``splu_pairs`` and ``gather_rows``. The BSR path is the
sparse products of ``russell_tpu_torch.sparse`` — ``bsr_from_coo`` →
``bsr_matvec`` / ``bsr_matmat`` and ``spgemm_plan`` → ``spgemm`` — whose
CUDA kernels are ``bsr_spmv``, ``bsr_spmm`` and ``spgemm_blocks``.

1. device: the card's name and power limit (nvidia-smi);
2. build: all five kernels compiled from ``russell_tpu_torch/csrc``, one
   nvcc per source, all at once, with ptxas' register and spill lines;
3. kernels: each SPLU kernel against its plain PyTorch version on the
   card, at the shapes of one row of the npoint-129 plan, with its median
   time, its bound and (gather_rows) the library call's time;
4. the van der Pol oracle: all nine radau5.f counters, exactly;
5. the npoint-16 Brusselator: the reference package's counters, exactly;
6. the main path: npoint 129, tolerances 1e-4, t in [0, 1], cold and warm,
   with each kernel's launch count from that run;
7. layers: one factorize pair, one solve pair and the diagonal-block
   inversion of one row, timed on the npoint-129 matrix;
8. bsr_kernels: each BSR kernel against its plain version on the card on
   the npoint-129 Brusselator Jacobian (8x128 blocks for SpMV and SpMM at
   m = 16, 16x16 blocks for A·A), with the same numbers;
9. bsr_path: the BSR path through the public entry points on the
   npoint-513 Brusselator Jacobian J(y0) (n 526,338), with launch counts
   and peak device memory; then each product held against its kernel's
   plain version on the same inputs (every entry) and against scipy on
   the host, with the kernel, plain and library times, nnz/s, GB/s and
   roofline share at these shapes. The kernels line reports the BSR
   kernels from this phase.

Every phase raises on failure, so the exit code is non-zero. The line
before the last is the kernels' JSON; the last is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import russell_tpu_torch  # noqa: F401  (fails at once outside the repo)

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
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
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
    for name in _cuda.KERNELS:
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


def phase_kernels(plan):
    """Each kernel against its plain version at one row's shapes."""
    from russell_tpu_torch.sparse import splu
    sp = plan.splu_plan
    pk = sp.packed
    dev = torch.device("cuda")
    dp = splu._device_plan(sp, dev)
    TL = pk["TL"]
    npair = np.asarray([r[3] for r in dp["rows"]])
    lens = np.asarray([r[1] for r in dp["rows"]])
    r_pair = int(npair.argmax())
    r_len = int(lens.argmax())
    rng = np.random.default_rng(SEED)
    n_store = sp.nblk + TL + 1
    results = {}
    for be in (sp.b, 2 * sp.b):
        blocks = torch.as_tensor(
            rng.standard_normal((n_store, be * be)), device=dev)
        r, n = r_pair, int(npair[r_pair])
        args = (blocks, dp["pair_l"][r, :n], dp["pair_u"][r, :n],
                dp["pair_seg"][r, :n], dp["seg_ptr"][r], be)
        got = splu.splu_pairs(*args)
        want = splu._splu_pairs_plain(*args[:4], TL, be)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        # the sum order differs (per-lane FMA loop vs bmm + index_add_)
        torch.testing.assert_close(got, want, rtol=1e-12,
                                   atol=1e-12 * scale)
        ms = time_ms(lambda: splu.splu_pairs(*args))
        plain_ms = time_ms(lambda: splu._splu_pairs_plain(*args[:4], TL, be))
        # each distinct tile read once, the lanes written once, the index
        # arrays the kernel reads; 2 be^3 flops per pair
        tiles = torch.unique(torch.cat([args[1], args[2]])).numel()
        b_ms, b_by = bound(8 * be * be * (tiles + TL) + 4 * (2 * n + TL + 1),
                           2 * n * be ** 3)
        say("kernel", name="splu_pairs", row=r, TL=TL, pairs=n, be=be,
            max_abs_err=err, scale=scale, rtol=1e-12, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
        results.setdefault("splu_pairs", []).append(
            (err, ms, plain_ms, None, b_ms, b_by))

        idx = dp["dinv"][r_len, :int(lens[r_len])]
        got = splu.gather_rows(blocks, idx)
        want = splu._gather_rows_plain(blocks, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows differs from blocks[idx] "
                                 f"at W={be * be}")
        ms = time_ms(lambda: splu.gather_rows(blocks, idx))
        plain_ms = time_ms(lambda: splu._gather_rows_plain(blocks, idx))
        library_ms = time_ms(lambda: torch.index_select(blocks, 0, idx))
        rows = int(idx.numel())
        b_ms, b_by = bound(8 * be * be * (torch.unique(idx).numel() + rows)
                           + 4 * rows, 0)
        say("kernel", name="gather_rows", row=r_len, rows=rows,
            W=be * be, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        results.setdefault("gather_rows", []).append(
            (0.0, ms, plain_ms, library_ms, b_ms, b_by))
        del blocks
    torch.cuda.empty_cache()
    return results


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
                    "gather_rows": splu.gather_rows.launches}
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
        for name, n in launches.items():
            if n < need:
                raise AssertionError(f"main path: {name} launched {n} "
                                     f"times, fewer than n_factor x rows "
                                     f"= {need}")
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
    factor_ms = time_ms(fact, reps=3, warmup=0)
    rng = np.random.default_rng(SEED)
    n = sol.ndim
    br = torch.as_tensor(rng.standard_normal(n), device=y.device)
    bc = torch.complex(br, torch.as_tensor(rng.standard_normal(n),
                                           device=y.device))
    solve_ms = time_ms(lambda: factor.factor_solve_pair(
        r5.plan, fr, fc, br, bc, refine_steps=0), reps=10)
    sp = r5.plan.splu_plan
    nd = max(r[2] for r in splu._device_plan(sp, y.device)["rows"])
    D = torch.as_tensor(rng.standard_normal((nd, 64, 64)), device=y.device)
    delta = torch.tensor(1e-14, dtype=torch.float64, device=y.device)
    inv32_ms = time_ms(lambda: splu._inv_block(D[:, :32, :32], delta))
    inv64_ms = time_ms(lambda: splu._inv_block(D, delta))
    say("layers", factorize_pair_wall_ms=[1e3 * w for w in walls],
        factorize_pair_device_ms=factor_ms, solve_pair_ms=solve_ms,
        inv_block_lanes=nd, inv_block_b32_ms=inv32_ms,
        inv_block_b64_ms=inv64_ms)


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


def bsr_work(bsr, m):
    """(bytes, flops) of Y = A X with X (n_cols, m): each live block read
    once (pads are skipped), col ids and mask, X read and Y written once;
    2 flops per stored block entry and column of X."""
    live = int((bsr.mask > 0).sum())
    return (8 * (live * bsr.bm * bsr.bn + (bsr.n_cols + bsr.n_rows) * m)
            + 12 * bsr.col_ids.numel(), 2 * live * bsr.bm * bsr.bn * m)


def spgemm_work(plan, a):
    """(bytes, flops) of A·A over ``plan`` (A and B are one input): each
    distinct block the products use read once, the index arrays the kernel
    reads, each C block written once; 2 bm bk bn flops per product."""
    n_ops = len(plan.a_idx)
    tiles = np.unique(np.concatenate([plan.a_idx, plan.b_idx])).size
    blk = a.bm * a.bn
    return (8 * blk * (tiles + plan.c_blocks)
            + 4 * (2 * n_ops + plan.c_blocks + 1),
            2 * n_ops * a.bm * a.bn * a.bn)


def phase_bsr_kernels():
    """Each BSR kernel against its plain version on the npoint-129
    Jacobian, with its time, the plain version's, the library call's and
    its bound (printed here; the kernels line takes ``bsr_path``'s)."""
    from russell_tpu_torch.sparse import kernels
    dev = torch.device("cuda")
    coo = brusselator_jacobian(NPOINT)
    a_csr = torch_csr(scipy_csr(coo), dev)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=dev)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, SPMM_M)), device=dev)
    bsr8 = kernels.bsr_from_coo(coo, 8, 128, dev)
    bsr16 = kernels.bsr_from_coo(coo, 16, 16, dev)
    plan = kernels.spgemm_plan(bsr16, bsr16)
    dp = kernels._device_plan(plan, dev)
    say("bsr_shapes", npoint=NPOINT, n=coo.nrow, coo_entries=coo.nnz,
        bsr8=[bsr8.nbr, bsr8.blocks_per_row, int((bsr8.mask > 0).sum())],
        bsr16=[bsr16.nbr, bsr16.blocks_per_row,
               int((bsr16.mask > 0).sum())],
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (lambda: kernels.bsr_matvec(bsr8, x),
                     lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(bsr8, 1)),
        "bsr_spmm": (lambda: kernels.bsr_matmat(bsr8, X),
                     lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            lambda: kernels.spgemm(plan, bsr16, bsr16)[0],
            lambda: kernels._spgemm_plain(dp, bsr16, bsr16, plan.c_blocks),
            lambda: torch.sparse.mm(a_csr, a_csr), spgemm_work(plan, bsr16)),
    }
    for name, (kern, plain, lib, (nbytes, flops)) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, scale = assert_close(name, got, want)
        b_ms, b_by = bound(nbytes, flops)
        say("bsr_kernel", name=name, npoint=NPOINT, scale=scale, rtol=RTOL,
            bytes=nbytes, flops=flops, max_abs_err=err, ms=time_ms(kern),
            plain_ms=time_ms(plain), library_ms=time_ms(lib), bound_ms=b_ms,
            bound_by=b_by)
    torch.cuda.empty_cache()


def phase_bsr_path():
    """The BSR path through the public entry points on the npoint-513
    Jacobian. Each result is held against its kernel's plain version on
    the same inputs (every output entry, every C block) and against scipy
    on the host; the kernel, plain and library calls are timed at these
    shapes."""
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
    y = bsr_matvec(bsr8, x)
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
    C, cij = spgemm(plan, bsr16, bsr16)
    spgemm_ms = time_ms(lambda: spgemm(plan, bsr16, bsr16))
    torch.cuda.synchronize()
    launches = {"bsr_spmv": bsr_matvec.launches,
                "bsr_spmm": bsr_matmat.launches,
                "spgemm_blocks": spgemm.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"bsr_path: {name} was not launched")

    # each kernel against its plain version on the same inputs, in full
    dp = kernels._device_plan(plan, dev)
    a_csr = torch_csr(a, dev)
    # torch's CUDA BSR product takes square blocks only, so the SpMV and
    # SpMM yardsticks are the CSR products (cuSPARSE SpMV / SpMM)
    cases = {
        "bsr_spmv": (y, spmv_ms, lambda: kernels._bsr_matvec_plain(bsr8, x),
                     lambda: a_csr @ x, bsr_work(bsr8, 1)),
        "bsr_spmm": (Y, spmm_ms, lambda: kernels._bsr_matmat_plain(bsr8, X),
                     lambda: a_csr @ X, bsr_work(bsr8, SPMM_M)),
        "spgemm_blocks": (
            C, spgemm_ms,
            lambda: kernels._spgemm_plain(dp, bsr16, bsr16, plan.c_blocks),
            lambda: torch.sparse.mm(a_csr, a_csr), spgemm_work(plan, bsr16)),
    }
    results = {}
    for name, (got, ms, plain, lib, (nbytes, flops)) in cases.items():
        want = plain()
        err, scale = assert_close(f"{name} vs plain", got, want)
        del want
        plain_ms = time_ms(plain)
        torch.cuda.empty_cache()
        library_ms = time_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
        say("bsr_path_kernel", name=name, npoint=NPOINT_BSR, scale=scale,
            rtol=RTOL, **results[name])
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
            ("bsr_spmv", bsr_work(bsr8, 1), nnz),
            ("bsr_spmm", bsr_work(bsr8, SPMM_M), nnz),
            ("spgemm_blocks", spgemm_work(plan, bsr16), None)):
        ms, b_ms = results[name]["ms"], results[name]["bound_ms"]
        metrics[name] = {
            "ms": ms, "launches": launches[name], "bytes": nbytes,
            "flops": flops, "GB_per_s": nbytes / ms / 1e6,
            "GFLOP_per_s": flops / ms / 1e6, "bound_ms": b_ms,
            "bound_by": results[name]["bound_by"],
            "roofline_share": b_ms / ms}
        if per is not None:
            metrics[name]["nnz_per_s"] = per / ms * 1e3
    metrics["bsr_spmm"]["nnz_rhs_per_s"] = nnz * SPMM_M / spmm_ms * 1e3
    metrics["spgemm_blocks"]["products_per_s"] = (
        len(plan.a_idx) / spgemm_ms * 1e3)
    say("bsr_path", npoint=NPOINT_BSR, n=n, nnz=nnz, coo_entries=coo.nnz,
        jacobian_and_scipy_s=setup_s, bsr_from_coo_8x128_s=bsr8_s,
        bsr_from_coo_16x16_s=bsr16_s, spgemm_plan_s=plan_s,
        check_s=check_s,
        bsr8={"nbr": bsr8.nbr, "bpr": bsr8.blocks_per_row,
              "live_blocks": int((bsr8.mask > 0).sum()),
              "stored_GB": bsr8.blocks.numel() * 8 / 1e9},
        bsr16={"nbr": bsr16.nbr, "bpr": bsr16.blocks_per_row,
               "live_blocks": int((bsr16.mask > 0).sum())},
        spgemm_ops=len(plan.a_idx), c_blocks=plan.c_blocks,
        C_GB=C.numel() * 8 / 1e9, spmm_m=SPMM_M,
        err_vs_scipy={"y": err_y, "y_scale": scale_y, "Y": err_Y,
                      "Y_scale": scale_Y, "C": err_C, "C_scale": scale_C,
                      "C_block_rows": sample},
        peak_mem_bytes=peak, **metrics)
    return launches, results


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    plan = brusselator_plan(NPOINT)
    plan_rows = len(plan.splu_plan.packed["t0"])
    say("plan", npoint=NPOINT, ndim=plan.n, nblk=plan.splu_plan.nblk,
        rows=plan_rows, TL=plan.splu_plan.packed["TL"],
        C=int(plan.splu_plan.packed["pair_l"].shape[1]))
    kres = phase_kernels(plan)
    phase_van_der_pol()
    phase_brusselator_small()
    sol, y, runs = phase_main_path(plan_rows)
    phase_layers(sol, y)
    del sol, y
    torch.cuda.empty_cache()
    phase_bsr_kernels()
    bsr_launches, bres = phase_bsr_path()
    src = {"splu_pairs": ("russell_tpu_torch/csrc/splu_pairs.cu",
                          "russell_tpu/sparse/splu.py:561"),
           "gather_rows": ("russell_tpu_torch/csrc/gather_rows.cu",
                           "russell_tpu/sparse/splu.py:634"),
           "bsr_spmv": ("russell_tpu_torch/csrc/bsr_spmv.cu",
                        "russell_tpu/sparse/kernels.py:106"),
           "bsr_spmm": ("russell_tpu_torch/csrc/bsr_spmm.cu",
                        "russell_tpu/sparse/kernels.py:186"),
           "spgemm_blocks": ("russell_tpu_torch/csrc/spgemm_blocks.cu",
                             "russell_tpu/sparse/kernels.py:306")}
    kernels = []
    for name, res in kres.items():
        # one factorize row: the real (b) and complex (2b) states summed
        lib = [r[3] for r in res]
        by = max(res, key=lambda r: r[4])[5]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1],
            "launches": runs["warm"]["launches"][name],
            "max_abs_err": max(r[0] for r in res),
            "ms": sum(r[1] for r in res),
            "plain_ms": sum(r[2] for r in res),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(r[4] for r in res), "bound_by": by,
            "shapes": "one npoint-129 SPLU factorize row, b 32 + 2b 64"})
    for name, res in bres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": bsr_launches[name],
            **res, "shapes": f"npoint-{NPOINT_BSR} Brusselator Jacobian"})
    say("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
