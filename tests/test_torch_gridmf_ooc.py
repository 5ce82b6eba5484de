"""Out-of-core GRIDMF in russell_tpu_torch against russell_tpu's, on the CPU.

The reference's out-of-core path (``gridmf_factorize_ooc`` /
``gridmf_solve_ooc``, forced by ``RUSSELL_TPU_GRIDMF_MEM_GB`` and, for the
node-chunked depths, ``RUSSELL_TPU_GRIDMF_CHUNK_GB``, as
``tests/test_gridmf.py`` forces it) runs once a module on small grids; the
port's runs on the same plans and values (made from a seed with numpy), its
constants ``gridmf.GRIDMF_CHUNK_GB`` / ``GRIDMF_STEP_GB`` and
``factor.GRIDMF_BUDGET_GB`` patched instead. Held: every level's factors,
x, log|det|, min|pivot| and n_perturbed against the reference's; the port's
out-of-core run against its in-core run bit for bit (the extend-add is the
in-core gathers and each chunk runs the in-core operations); LinSolver end
to end; complex values refused; Radau5's pair, the fused loop and a batch in
core, as the reference runs them under jit and vmap; interop both ways; the
example. f64 on the CPU.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.sparse import factor as jfactor, gridmf as jgridmf
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch import interop
from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
from russell_tpu_torch.sparse import (CooMatrix, LinSolParams, LinSolver,
                                      VerifyLinSys, factor, gridmf)
from russell_tpu_torch.sparse import samples as ssamples
from russell_tpu_torch.sparse.enums import Genie

from test_gridmf import _stencil_coo, _stencil_coo_3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
# (grid shape, species, leaf cells): a 2-D and a 3-D grid of 3 depths each,
# a depth's fronts 0.6-128 KB (the reference compiles every depth's
# programs: ~4-6 s a grid and branch)
GRIDS = {"2d": ((12, 12), 1, 4), "3d": ((3, 3, 23), 1, 4)}
# the chunk budget (GiB) of each branch: every depth whole, and node chunks
# of one node where a depth's fronts exceed ~1 KB (every 2-D depth, the
# 3-D one's but the root, which then takes its children's Schur
# complements from host memory whole)
CHUNK_GB = {"whole": 2.0, "chunked": 1e-6}
# the (grid, branch) runs held against the reference: both branches, both
# dimensions, in two runs (the port's own runs cover every pairing below)
CASES = [("2d", "chunked"), ("3d", "whole")]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(grid):
    shape, s, leaf = GRIDS[grid]
    rng = np.random.default_rng(17)
    make = _stencil_coo if len(shape) == 2 else _stencil_coo_3d
    n, rows, cols, vals = make(*shape, s, rng)
    return n, rows, cols, vals, rng.normal(size=n), shape + (s,), leaf


@pytest.fixture(scope="module")
def reference():
    """{(grid, branch): the reference's out-of-core fac and x}, with the
    plans and inputs of each grid."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for grid in GRIDS:
            n, rows, cols, vals, b, hint, leaf = _problem(grid)
            jp = jgridmf.gridmf_analyze(n, rows, cols, hint, leaf_cells=leaf)
            tp = gridmf.gridmf_analyze(n, rows, cols, hint, leaf_cells=leaf)
            for branch in (br for g, br in CASES if g == grid):
                mp.setenv("RUSSELL_TPU_GRIDMF_CHUNK_GB",
                          repr(CHUNK_GB[branch]))
                jf = jgridmf.gridmf_factorize_ooc(jp, jnp.asarray(vals))
                assert isinstance(jf["levels"][0]["sir"], np.ndarray)
                x = np.asarray(jgridmf.gridmf_solve_ooc(jp, jf,
                                                        jnp.asarray(b)))
                out[grid, branch] = (jf, x)
            out[grid] = (jp, tp, vals, b)
    return out


def _port_ooc(tp, vals, b, chunk_gb, step_gb=gridmf.GRIDMF_STEP_GB):
    old = gridmf.GRIDMF_CHUNK_GB, gridmf.GRIDMF_STEP_GB
    gridmf.GRIDMF_CHUNK_GB, gridmf.GRIDMF_STEP_GB = chunk_gb, step_gb
    try:
        tf = gridmf.gridmf_factorize_ooc(tp, torch.as_tensor(vals))
    finally:
        gridmf.GRIDMF_CHUNK_GB, gridmf.GRIDMF_STEP_GB = old
    return tf, gridmf.gridmf_solve_ooc(tp, tf, torch.as_tensor(b))


def _chunked_depths(plan, chunk_gb):
    return sum(lv.n_nodes * lv.F ** 2 * 8 > chunk_gb * 2 ** 30
               for lv in plan.levels)


@pytest.mark.parametrize("grid,branch", CASES)
def test_ooc_factors_match_reference(reference, grid, branch):
    jp, tp, vals, b = reference[grid]
    jf, xj = reference[grid, branch]
    chunked = _chunked_depths(tp, CHUNK_GB[branch])
    assert chunked == 0 if branch == "whole" else chunked >= len(
        tp.levels) - 1
    tf, xt = _port_ooc(tp, vals, b, CHUNK_GB[branch])
    assert isinstance(tf["levels"], gridmf.HostLevels)
    for d, (a, c) in enumerate(zip(jf["levels"], tf["levels"])):
        for k in ("sir", "lr", "br"):
            got, want = c[k].numpy(), a[k]
            assert got.shape == want.shape, (d, k)
            if want.size:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=RTOL * np.max(np.abs(want)),
                    err_msg=f"level {d} {k}")
        assert all(c[k] is None and a[k] is None for k in ("sii", "li", "bi"))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=RTOL * np.max(np.abs(xj)))
    np.testing.assert_allclose(float(tf["logdet"]), float(jf["logdet"]),
                               rtol=1e-10)
    # the reference's per-depth jit contracts products into FMAs: the
    # pivots' last bits may differ (tests/test_torch_gridmf.py holds the
    # in-core min|pivot| at the same rtol)
    np.testing.assert_allclose(float(tf["min_pivot"]),
                               float(jf["min_pivot"]), rtol=RTOL)
    assert int(tf["n_perturbed"]) == int(jf["n_perturbed"])
    assert float(tf["phase"]) == float(jf["phase"])


# (chunk GiB, step GiB) of each run held against the in-core run: every
# depth whole in one step, whole in steps of 2 nodes, all chunked, and the
# leaves chunked under whole upper depths (the children's Schur
# complements then come back from host memory to a whole depth)
SPLITS = {"whole": (2.0, 1.5), "steps": (2.0, 1e-7), "chunked": (1e-6, 1.5),
          "mixed": (5e-5, 1.5)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("split", list(SPLITS))
def test_ooc_equals_in_core_bit_for_bit(reference, grid, split):
    _, tp, vals, b = reference[grid]
    chunk_gb, step_gb = SPLITS[split]
    if split == "mixed":
        assert 0 < _chunked_depths(tp, chunk_gb) < len(tp.levels)
    ti = gridmf.gridmf_factorize(tp, torch.as_tensor(vals))
    xi = gridmf.gridmf_solve(tp, ti, torch.as_tensor(b))
    to, xo = _port_ooc(tp, vals, b, chunk_gb, step_gb)
    for a, c in zip(ti["levels"], to["levels"]):
        for k in ("sir", "lr", "br"):
            assert torch.equal(a[k], c[k]), k
    assert torch.equal(xi, xo)
    for k in ("logdet", "min_pivot", "n_perturbed", "phase"):
        assert torch.equal(ti[k], to[k]), k


def test_analyze_marks_the_plan_as_the_reference_does(monkeypatch):
    coo = ssamples.laplacian_2d(16)
    ii, jj, _ = map(np.asarray, coo.triplets())
    n = coo.nrow
    store = gridmf.gridmf_store_gb(gridmf.gridmf_analyze(
        n, ii, jj, (16, 16, 1), leaf_cells=factor.GRIDMF_LEAVES[-1]))
    for budget, ooc in ((0.9 * store, True), (1.1 * store, False)):
        monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", budget)
        # the reference counts f32 bytes a value: half the budget is the same
        monkeypatch.setenv("RUSSELL_TPU_GRIDMF_MEM_GB", repr(budget / 2))
        tp = factor.analyze(n, ii, jj, genie=Genie.GRIDMF, grid=(16, 16, 1))
        jp = jfactor.analyze(n, ii, jj, genie=JGenie.GRIDMF, grid=(16, 16, 1))
        assert tp.gridmf_ooc is jp.gridmf_ooc is ooc
        np.testing.assert_array_equal(tp.gridmf_plan.entry_perm,
                                      jp.gridmf_plan.entry_perm)


def test_lin_solver_out_of_core_end_to_end(monkeypatch):
    monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", 1e-9)
    coo = ssamples.laplacian_2d(16)
    sol = LinSolver(Genie.GRIDMF, device="cpu")
    sol.factorize(coo, LinSolParams(grid=(16, 16, 1)))
    assert sol.stats.output["out_of_core"] is True
    assert sol.plan.gridmf_ooc
    assert isinstance(sol.fac["levels"], gridmf.HostLevels)
    assert len(sol.fac["levels"]) > 1
    b = np.sin(np.arange(coo.nrow))
    x = sol.solve(b)
    assert VerifyLinSys.from_system(coo, x, b).relative_error < 1e-10
    mant, base, expo = sol.determinant()
    sign, logabs = np.linalg.slogdet(coo.as_dense())
    assert base == 10.0 and np.sign(mant) == sign
    assert abs(expo + np.log10(abs(mant)) - logabs / np.log(10)) < 1e-10
    # kernel_fns factorize out of core too, and solve the same
    fact, solve = sol.kernel_fns()
    fac = fact(torch.as_tensor(np.asarray(coo.triplets()[2])))
    assert isinstance(fac["levels"], gridmf.HostLevels)
    assert torch.equal(solve(fac, torch.as_tensor(b)), x)
    # complex values are refused out of core, as in the reference
    ii, jj, vv = map(np.asarray, coo.triplets())
    cz = CooMatrix.from_arrays(coo.nrow, coo.ncol, ii, jj, vv + 0.5j)
    with pytest.raises(NotImplementedError, match="real"):
        LinSolver(Genie.GRIDMF, device="cpu").factorize(
            cz, LinSolParams(grid=(16, 16, 1)))


def test_pair_fused_and_batch_run_in_core(monkeypatch):
    # the reference's Radau5 factorizes its pair under jit, its fused loop
    # and solve_batch under jit and vmap, so an out-of-core plan runs in
    # core there (found with RUSSELL_TPU_GRIDMF_MEM_GB=1e-9 on the npoint-5
    # Brusselator: its factors stay device arrays); so do the port's
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 5)
    runs = {}
    for budget in (factor.GRIDMF_BUDGET_GB, 1e-9):
        monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", budget)
        params = Params(Method.RADAU5)
        params.newton.genie = Genie.GRIDMF
        sol = OdeSolver(params, system, "cpu")
        y = sol.solve(torch.as_tensor(y0), t0, 0.1).clone()
        assert sol.actual.plan.gridmf_ooc is (budget == 1e-9)
        assert not isinstance(sol.actual.fac_real["levels"],
                              gridmf.HostLevels)
        yf = sol.solve(torch.as_tensor(y0), t0, 0.1, fused=True)
        runs[budget] = (y, yf)
        plan = sol.actual.plan
    a, b = runs.values()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # a batch (B, nnz) over the out-of-core plan factorizes in core
    n = plan.n
    vals = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, len(plan.rows)))) + 8.0 * torch.as_tensor(
            plan.rows == plan.cols)
    fac = factor.numeric_factorize(plan, vals)
    assert not isinstance(fac["levels"], gridmf.HostLevels)
    x = factor.factor_solve(plan, fac, torch.ones(2, n, dtype=torch.float64))
    assert x.shape == (2, n)


def test_interop_carries_ooc_factors_both_ways(reference):
    jp, tp, vals, b = reference["2d"]
    jf, xj = reference["2d", "chunked"]
    # the reference's host levels become the port's, and solve the same
    tf = interop.tree_to_torch(jf, "cpu")
    assert isinstance(tf["levels"], gridmf.HostLevels)
    xt = gridmf.gridmf_solve_ooc(tp, tf, torch.as_tensor(b))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=RTOL * np.max(np.abs(xj)))
    # the port's come back as numpy levels, which the reference solves
    to, xo = _port_ooc(tp, vals, b, 2.0)
    back = interop.tree_to_numpy(to)
    assert all(isinstance(st["sir"], np.ndarray) for st in back["levels"])
    xr = np.asarray(jgridmf.gridmf_solve_ooc(jp, back, jnp.asarray(b)))
    np.testing.assert_allclose(xr, xo.numpy(), rtol=0,
                               atol=RTOL * np.max(np.abs(xr)))


def test_ooc_stores_hold_each_depth_and_two_schur_buffers(reference,
                                                          monkeypatch):
    # made before the first depth: each depth's {sir, lr, br}, and two
    # buffers as large as the largest chunked depth's Schur complements
    _, tp, _, _ = reference["3d"]
    monkeypatch.setattr(gridmf, "GRIDMF_CHUNK_GB", CHUNK_GB["chunked"])
    levels, bufs = gridmf._ooc_stores(tp, torch.float64, torch.device("cpu"))
    assert isinstance(levels, gridmf.HostLevels)
    for lv, st in zip(tp.levels, levels):
        assert st["sir"].shape == (lv.n_nodes, lv.e, lv.e)
        assert st["lr"].shape == (lv.n_nodes, lv.r, lv.e)
        assert st["br"].shape == (lv.n_nodes, lv.e, lv.r)
        assert st["sii"] is st["li"] is st["bi"] is None
    most = max(lv.n_nodes * lv.r ** 2 for lv in tp.levels
               if gridmf._chunked(lv, 8))
    assert [tuple(b.shape) for b in bufs] == [(most,), (most,)]
    assert levels.pinned_bytes == 0          # nothing to pin on the CPU


def test_example_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ex_sparse_out_of_core.py", "--device",
                                      "cpu"])
    budget = factor.GRIDMF_BUDGET_GB
    runpy.run_path(os.path.join(ROOT, "examples_torch",
                                "ex_sparse_out_of_core.py"),
                   run_name="__main__")
    # the example cuts the budget to force out of core, and restores it
    assert factor.GRIDMF_BUDGET_GB == budget
