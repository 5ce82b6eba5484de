#!/usr/bin/env python3
"""Smoke run of russell_tpu_torch on one NVIDIA GPU.

Drives the port's main path — Radau5 on the 2-D Brusselator PDE through
the SPLU solver, whose factorize rows run the two CUDA kernels
``splu_pairs`` and ``gather_rows`` — and checks it:

1. device: the card's name and power limit (nvidia-smi);
2. build: both kernels compiled from ``russell_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of one row of the npoint-129 plan, with its median time;
4. the van der Pol oracle: all nine radau5.f counters, exactly;
5. the npoint-16 Brusselator: the reference package's counters, exactly;
6. the main path: npoint 129, tolerances 1e-4, t in [0, 1], cold and warm,
   with each kernel's launch count from that run;
7. layers: one factorize pair, one solve pair and the diagonal-block
   inversion of one row, timed on the npoint-129 matrix.

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
ALPHA = 2e-3
REPS = 20


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
    for name in ("splu_pairs", "gather_rows"):
        t0 = time.perf_counter()
        _cuda.library(name)
        info = _cuda.build_info(name)
        say("build", kernel=name, seconds=time.perf_counter() - t0,
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
        say("kernel", name="splu_pairs", row=r, TL=TL, pairs=n, be=be,
            max_abs_err=err, scale=scale, rtol=1e-12, ms=ms,
            plain_ms=plain_ms)
        results.setdefault("splu_pairs", []).append((err, ms, plain_ms))

        idx = dp["dinv"][r_len, :int(lens[r_len])]
        got = splu.gather_rows(blocks, idx)
        want = splu._gather_rows_plain(blocks, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows differs from blocks[idx] "
                                 f"at W={be * be}")
        ms = time_ms(lambda: splu.gather_rows(blocks, idx))
        plain_ms = time_ms(lambda: splu._gather_rows_plain(blocks, idx))
        say("kernel", name="gather_rows", row=r_len, rows=int(idx.numel()),
            W=be * be, max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
        results.setdefault("gather_rows", []).append((0.0, ms, plain_ms))
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
        splu.reset_launch_counts()
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


def main():
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
    src = {"splu_pairs": ("russell_tpu_torch/csrc/splu_pairs.cu",
                          "russell_tpu/sparse/splu.py:561"),
           "gather_rows": ("russell_tpu_torch/csrc/gather_rows.cu",
                           "russell_tpu/sparse/splu.py:634")}
    kernels = []
    for name, res in kres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1],
            "launches": runs["warm"]["launches"][name],
            "max_abs_err": max(e for e, _, _ in res),
            # one factorize row: the real (b) and complex (2b) states
            "ms": sum(m for _, m, _ in res),
            "plain_ms": sum(p for _, _, p in res)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
