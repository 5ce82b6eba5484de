"""The cases of ``tests/test_torch_parallel.py`` and the rank process that
runs them in a gloo world. This module imports torch and the port only,
never jax, so that each spawned rank starts without it.

The inputs are ``tests/test_parallel.py``'s f64 cases: the SpMV on
``laplacian_2d(10)``, a BANDED batch on ``(8)``, BCR on ``(40)``, SPLU on
``(16)`` (block size 16, nested dissection), GRIDMF on ``(33)`` (leaf 16
cells) and GENMF on ``(24)`` (leaf target 24); and the last four again
with complex values.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from russell_tpu_torch import parallel as par
from russell_tpu_torch.sparse import CsrMatrix, factor, genmf, gridmf, splu
from russell_tpu_torch.sparse import samples
from russell_tpu_torch.sparse.enums import Genie

BATCH = 16      # tests/test_parallel.py's 2 x 8 devices


def _triplets(coo):
    return tuple(np.asarray(a) for a in coo.triplets())


def cases():
    """Every case's port plan and inputs (host numpy values), keyed by
    name; ``coo`` is the matrix for the residuals."""
    out = {}
    coo = samples.laplacian_2d(10)
    out["spmv"] = {"coo": coo, "csr": CsrMatrix.from_coo(coo, "cpu")}
    coo = samples.laplacian_2d(8)
    ii, jj, vv = _triplets(coo)
    scale = 1.0 + 0.25 * np.arange(BATCH)[:, None]
    out["batch"] = {
        "coo": coo, "plan": factor.analyze(coo.nrow, ii, jj,
                                           genie=Genie.BANDED),
        "scale": scale, "vals": np.tile(vv[None, :], (BATCH, 1)) * scale,
        "rhs": np.tile(np.linspace(1.0, 2.0, coo.nrow)[None, :],
                       (BATCH, 1))}
    coo = samples.laplacian_2d(40)
    ii, jj, vv = _triplets(coo)
    out["bcr"] = {"coo": coo, "vals": vv,
                  "plan": factor.analyze(coo.nrow, ii, jj,
                                         genie=Genie.BANDED,
                                         banded_kernel="bcr"),
                  "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    coo = samples.laplacian_2d(16)
    ii, jj, vv = _triplets(coo)
    out["splu"] = {"coo": coo, "vals": vv,
                   "plan": splu.splu_analyze(coo.nrow, ii, jj, block_size=16,
                                             ordering="nd"),
                   "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    coo = samples.laplacian_2d(33)
    ii, jj, vv = _triplets(coo)
    out["gridmf"] = {"coo": coo, "vals": vv,
                     "plan": gridmf.gridmf_analyze(coo.nrow, ii, jj,
                                                   (33, 33, 1),
                                                   leaf_cells=16),
                     "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    coo = samples.laplacian_2d(24)
    ii, jj, vv = _triplets(coo)
    out["genmf"] = {"coo": coo, "vals": vv,
                    "plan": genmf.genmf_analyze(coo.nrow, ii, jj,
                                                leaf_target=24),
                    "rhs": np.linspace(1.0, 2.0, coo.nrow)}
    return out


def _complex(vals, rhs, seed):
    rng = np.random.default_rng(seed)
    return (vals + 0.3j * rng.standard_normal(len(vals)),
            rhs + 0.5j * rng.standard_normal(len(rhs)))


def _complex_results(cs, fns):
    """The BCR, SPLU, GRIDMF and GENMF cases on complex values (the real
    entries with a seeded imaginary part, and a complex right-hand side)
    through ``fns[name](plan, vals, rhs)`` -> (x, fac)."""
    out = {}
    for seed, name in enumerate(("bcr", "splu", "gridmf", "genmf")):
        c = cs[name]
        vals, rhs = _complex(c["vals"], c["rhs"], seed)
        x, fac = fns[name](c["plan"], vals, rhs)
        out[name] = {"x": _np(x), **_stats(fac)}
    return out


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _stats(fac):
    return {k: _np(fac[k]) for k in ("logdet", "phase", "min_pivot",
                                     "n_perturbed") if k in fac}


def run_dist(mesh, cs, world, rank):
    """Every case through ``russell_tpu_torch.parallel`` on this rank;
    results as numpy (split factors: this rank's blocks and ranges)."""
    res = {}
    c = cs["spmv"]
    sh = par.shard_csr_rows(c["csr"], world)
    rps = sh.rows_per_shard
    x = np.sin(np.arange(sh.n_pad, dtype=np.float64))
    res["spmv"] = {"y": _np(par.dist_mat_vec_mul(
        mesh, sh, x[rank * rps:(rank + 1) * rps])), "rps": rps}
    c = cs["batch"]
    res["batch"] = {"x": _np(par.batch_factor_solve(mesh, c["plan"],
                                                    c["vals"], c["rhs"]))}
    c = cs["bcr"]
    fac = par.shard_banded_factorize(mesh, c["plan"], c["vals"])
    res["bcr"] = {"x": _np(par.shard_banded_solve(mesh, c["plan"], fac,
                                                  c["rhs"])),
                  "ranges": [lv.get("range") for lv in fac["levels"]],
                  **_stats(fac)}
    c = cs["splu"]
    fac = par.dist_splu_factorize(mesh, c["plan"], c["vals"])
    res["splu"] = {"blocks": _np(fac["blocks"]),
                   "x": _np(splu.splu_solve(c["plan"], fac,
                                            torch.as_tensor(c["rhs"]))),
                   **_stats(fac)}
    c = cs["gridmf"]
    fac = par.dist_gridmf_factorize(mesh, c["plan"], c["vals"])
    res["gridmf"] = {"sir": [_np(lv["sir"]) for lv in fac["levels"]],
                     "ranges": fac["ranges"],
                     "x": _np(par.dist_gridmf_solve(mesh, c["plan"], fac,
                                                    c["rhs"])),
                     **_stats(fac)}
    c = cs["genmf"]
    fac = par.dist_genmf_factorize(mesh, c["plan"], c["vals"])
    res["genmf"] = {"sir": [_np(cl["sir"]) for cl in fac["classes"]],
                    "ranges": fac["ranges"],
                    "x": _np(par.dist_genmf_solve(mesh, c["plan"], fac,
                                                  c["rhs"])),
                    **_stats(fac)}

    def bcr(plan, v, b):
        fac = par.shard_banded_factorize(mesh, plan, v)
        return par.shard_banded_solve(mesh, plan, fac, b), fac

    def spl(plan, v, b):
        fac = par.dist_splu_factorize(mesh, plan, v)
        return splu.splu_solve(plan, fac, torch.as_tensor(b)), fac

    def grd(plan, v, b):
        fac = par.dist_gridmf_factorize(mesh, plan, v)
        return par.dist_gridmf_solve(mesh, plan, fac, b), fac

    def gen(plan, v, b):
        fac = par.dist_genmf_factorize(mesh, plan, v)
        return par.dist_genmf_solve(mesh, plan, fac, b), fac

    res["complex"] = _complex_results(cs, {"bcr": bcr, "splu": spl,
                                           "gridmf": grd, "genmf": gen})
    return res


def run_single(cs):
    """Every case through the single-device functions, in the shapes of
    ``run_dist``'s results for one rank."""
    res = {}
    c = cs["spmv"]
    n = c["csr"].nrow
    x = np.sin(np.arange(n, dtype=np.float64))
    res["spmv"] = {"y": _np(c["csr"].mat_vec_mul(torch.as_tensor(x))),
                   "rps": n}
    c = cs["batch"]
    plan = c["plan"]
    # the batch in one batched numeric phase, as batch_factor_solve runs
    # each rank's rows
    res["batch"] = {"x": _np(factor.factor_solve_batch(
        plan, torch.as_tensor(c["vals"]), torch.as_tensor(c["rhs"])))}
    c = cs["bcr"]
    fac = factor.numeric_factorize(c["plan"], torch.as_tensor(c["vals"]))
    res["bcr"] = {"x": _np(factor.factor_solve(c["plan"], fac,
                                               torch.as_tensor(c["rhs"]))),
                  "ranges": None, **_stats(fac)}
    c = cs["splu"]
    fac = splu.splu_factorize(c["plan"], torch.as_tensor(c["vals"]))
    res["splu"] = {"blocks": _np(fac["blocks"]),
                   "x": _np(splu.splu_solve(c["plan"], fac,
                                            torch.as_tensor(c["rhs"]))),
                   **_stats(fac)}
    c = cs["gridmf"]
    fac = gridmf.gridmf_factorize(c["plan"], torch.as_tensor(c["vals"]))
    res["gridmf"] = {"sir": [_np(lv["sir"]) for lv in fac["levels"]],
                     "ranges": None,
                     "x": _np(gridmf.gridmf_solve(c["plan"], fac,
                                                  torch.as_tensor(c["rhs"]))),
                     **_stats(fac)}
    c = cs["genmf"]
    fac = genmf.genmf_factorize(c["plan"], torch.as_tensor(c["vals"]))
    res["genmf"] = {"sir": [_np(cl["sir"]) for cl in fac["classes"]],
                    "ranges": None,
                    "x": _np(genmf.genmf_solve(c["plan"], fac,
                                               torch.as_tensor(c["rhs"]))),
                    **_stats(fac)}

    def one(fact, solve):
        def run(plan, v, b):
            fac = fact(plan, torch.as_tensor(v))
            return solve(plan, fac, torch.as_tensor(b)), fac
        return run

    res["complex"] = _complex_results(cs, {
        "bcr": one(factor.numeric_factorize, factor.factor_solve),
        "splu": one(splu.splu_factorize, splu.splu_solve),
        "gridmf": one(gridmf.gridmf_factorize, gridmf.gridmf_solve),
        "genmf": one(genmf.genmf_factorize, genmf.genmf_solve)})
    return res


def rank_main(rank, world, init_method, cs, out_dir):
    """One rank of a gloo world on the CPU: join it, run every case, write
    the results to ``out_dir``/rank<r>.pkl, leave the group."""
    # this torch build can deadlock in batched LAPACK on more threads
    torch.set_num_threads(1)
    par.initialize_multihost(num_processes=world, process_id=rank,
                             init_method=init_method, device="cpu")
    try:
        res = run_dist(par.make_mesh(device="cpu"), cs, world, rank)
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
