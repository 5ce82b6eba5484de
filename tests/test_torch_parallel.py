"""russell_tpu_torch.parallel against russell_tpu's results, on the CPU.

One gloo world of two ranks is spawned once for the module
(``tests/_torch_parallel_ranks.py``: start method spawn, a file store in a
temporary directory, one intra-op thread a rank). Each rank runs every case
of ``tests/test_parallel.py`` at f64 through the port's ``parallel``
package and writes its results; this process computes the reference's
single-device results with the JAX package and holds the ranks' to them
at that test file's bounds: factors within 1e-12 (1 + max|.|), the
absolute residual below 1e-9 (1e-10 for BANDED), log|det| within 1e-8.
Every rank must hold the same bits. A world of one rank, in this process,
must give the port's single-device results bit for bit, also on the f32
cases of that file (at its f32 bars, against the reference's f64
factors); the mesh and the plans' refusals are checked there too.
"""

import multiprocessing
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_ranks as ranks
from russell_tpu import parallel as jpar
from russell_tpu.sparse import CsrMatrix as JCsr
from russell_tpu.sparse import factor as jfactor, genmf as jgenmf
from russell_tpu.sparse import gridmf as jgridmf, splu as jsplu
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch import parallel as par
from russell_tpu_torch.sparse import factor, samples
from russell_tpu_torch.sparse.enums import Genie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_S = 120          # a rank that has not finished by then fails the test
FAC_TOL = 1e-12       # factors, relative to 1 + max|.|
RES_TOL = 1e-9        # absolute residual max|A x - b|
RES_TOL_BANDED = 1e-10
LOGDET_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, before the module's other fixtures: torch's CPU
    build can deadlock in batched LAPACK calls run on more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two-rank world, started at once; yields (cases, results), where
    ``results()`` waits for the ranks (JOIN_S each) and returns their
    result dicts in rank order."""
    out = tmp_path_factory.mktemp("gloo_world")
    cs = ranks.cases()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_main,
                         args=(r, WORLD, f"file://{out}/store", cs, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = []

    def results():
        if not got:
            for p in procs:
                p.join(JOIN_S)
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
            codes = [p.exitcode for p in procs]
            assert codes == [0] * WORLD, f"rank exit codes {codes}"
            for r in range(WORLD):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    got.append(pickle.load(f))
        return got

    yield cs, results
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)


def _ref_spmv(c):
    x = np.sin(np.arange(c["coo"].nrow, dtype=np.float64))
    return np.asarray(JCsr.from_coo(c["coo"]).mat_vec_mul(jnp.asarray(x)))


def _ref_batch(c):
    ii, jj = _jtriplets(c)
    plan = jfactor.analyze(c["coo"].nrow, ii, jj, genie=JGenie.BANDED)
    return np.asarray(jpar.batch_factor_solve(
        jpar.make_mesh(1), plan, jnp.asarray(c["vals"]),
        jnp.asarray(c["rhs"])))


def _ref_bcr(c):
    ii, jj = _jtriplets(c)
    plan = jfactor.analyze(c["coo"].nrow, ii, jj, genie=JGenie.BANDED,
                           banded_kernel="bcr")
    fac = jax.jit(lambda v: jfactor.numeric_factorize(plan, v))(_jvals(c))
    x = jax.jit(lambda f, b: jfactor.factor_solve(plan, f, b))(
        fac, jnp.asarray(c["rhs"]))
    return {"x": np.asarray(x), "logdet": float(fac["logdet"]),
            "phase": float(fac["phase"])}


def _ref_splu(c):
    ii, jj = _jtriplets(c)
    plan = jsplu.splu_analyze(c["coo"].nrow, ii, jj, block_size=16,
                              ordering="nd")
    fac = jsplu.splu_factorize(plan, _jvals(c))
    return {"blocks": np.asarray(fac["blocks"]),
            "logdet": float(fac["logdet"]), "phase": float(fac["phase"])}


def _ref_gridmf(c):
    ii, jj = _jtriplets(c)
    plan = jgridmf.gridmf_analyze(c["coo"].nrow, ii, jj, (33, 33, 1),
                                  leaf_cells=16)
    assert max(lv.n_nodes for lv in plan.levels) >= 8
    fac = jax.jit(lambda v: jgridmf.gridmf_factorize(plan, v))(_jvals(c))
    return {"sir": [np.asarray(lv["sir"]) for lv in fac["levels"]],
            "logdet": float(fac["logdet"])}


def _ref_genmf(c):
    ii, jj = _jtriplets(c)
    plan = jgenmf.genmf_analyze(c["coo"].nrow, ii, jj, leaf_target=24)
    assert max(cl.n_nodes for cl in plan.classes) >= 8
    fac = jax.jit(lambda v: jgenmf.genmf_factorize(plan, v))(_jvals(c))
    x = jax.jit(lambda f, v: jgenmf.genmf_solve(plan, f, v))(
        fac, jnp.asarray(c["rhs"]))
    return {"sir": [np.asarray(cl["sir"]) for cl in fac["classes"]],
            "x": np.asarray(x), "logdet": float(fac["logdet"])}


@pytest.fixture(scope="module")
def reference(world):
    """The JAX package's single-device results of every case, computed in
    threads while the ranks run (XLA compiles them without the GIL)."""
    cs, _ = world
    with ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(fn, cs[name]) for name, fn in (
            ("genmf", _ref_genmf), ("gridmf", _ref_gridmf),
            ("bcr", _ref_bcr), ("splu", _ref_splu), ("batch", _ref_batch),
            ("spmv", _ref_spmv))}
        return {name: f.result() for name, f in futs.items()}


def _same_on_every_rank(res, name, key):
    first = res[0][name][key]
    for r in res[1:]:
        assert np.array_equal(r[name][key], first), (name, key)
    return first


def _whole(res, name, key, i):
    """Item i of a split factorization (depth or class), its ranks' blocks
    put together in rank order."""
    rng = res[0][name]["ranges"][i]
    if rng is None:
        parts = [r[name][key][i] for r in res]
        for p in parts[1:]:
            assert np.array_equal(p, parts[0])
        return parts[0]
    for r, rr in enumerate(res):
        n = rng[1] - rng[0]
        assert rr[name]["ranges"][i] == (r * n, (r + 1) * n)
    return np.concatenate([r[name][key][i] for r in res])


def _close(got, want, tol=FAC_TOL):
    want = np.asarray(want, dtype=np.float64)
    assert np.max(np.abs(got - want)) <= tol * (1 + np.max(np.abs(want)))


def _resid(coo, x, b):
    return np.max(np.abs(np.asarray(coo.as_dense()) @ x - b))


def _jvals(c):
    return jnp.asarray(c["vals"])


def _jtriplets(c):
    ii, jj, _ = c["coo"].triplets()
    return np.asarray(ii), np.asarray(jj)


def test_dist_spmv(world, reference):
    cs, results = world
    res = results()
    n = cs["spmv"]["coo"].nrow
    y = np.concatenate([r["spmv"]["y"] for r in res])
    np.testing.assert_allclose(y[:n], reference["spmv"], rtol=0, atol=1e-12)
    assert not y[n:].any()


def test_batch_factor_solve(world, reference):
    cs, results = world
    res = results()
    c = cs["batch"]
    X = _same_on_every_rank(res, "batch", "x")
    _close(X, reference["batch"])
    for i in (0, ranks.BATCH // 2, ranks.BATCH - 1):
        assert _resid(c["coo"], X[i] * c["scale"][i, 0],
                      c["rhs"][i]) < RES_TOL_BANDED


def test_distributed_bcr_factorization(world, reference):
    cs, results = world
    res = results()
    c = cs["bcr"]
    want = reference["bcr"]
    x = _same_on_every_rank(res, "bcr", "x")
    _close(x, want["x"])
    assert _resid(c["coo"], x, c["rhs"]) < RES_TOL_BANDED
    ld = _same_on_every_rank(res, "bcr", "logdet")
    assert abs(float(ld) - want["logdet"]) < LOGDET_TOL
    assert float(_same_on_every_rank(res, "bcr", "phase")) == want["phase"]
    # the first levels (more odd rows than ranks) are split
    first = [r["bcr"]["ranges"][0] for r in res]
    k = first[0][1]
    assert first == [(r * k, (r + 1) * k) for r in range(WORLD)]


def test_dist_splu_factorize_matches_single_chip(world, reference):
    cs, results = world
    res = results()
    c = cs["splu"]
    want = reference["splu"]
    _close(_same_on_every_rank(res, "splu", "blocks"), want["blocks"])
    assert _resid(c["coo"], _same_on_every_rank(res, "splu", "x"),
                  c["rhs"]) < RES_TOL
    assert float(_same_on_every_rank(res, "splu", "phase")) == want["phase"]
    assert abs(float(_same_on_every_rank(res, "splu", "logdet"))
               - want["logdet"]) < LOGDET_TOL


def test_dist_gridmf_matches_single_chip(world, reference):
    cs, results = world
    res = results()
    c = cs["gridmf"]
    want = reference["gridmf"]
    for d, sir in enumerate(want["sir"]):
        _close(_whole(res, "gridmf", "sir", d), sir)
    assert res[0]["gridmf"]["ranges"][-1] is not None     # leaves split
    assert _resid(c["coo"], _same_on_every_rank(res, "gridmf", "x"),
                  c["rhs"]) < RES_TOL
    assert abs(float(_same_on_every_rank(res, "gridmf", "logdet"))
               - want["logdet"]) < LOGDET_TOL


def test_dist_genmf_matches_single_chip(world, reference):
    cs, results = world
    res = results()
    c = cs["genmf"]
    want = reference["genmf"]
    for ci, sir in enumerate(want["sir"]):
        _close(_whole(res, "genmf", "sir", ci), sir)
    assert any(r is not None for r in res[0]["genmf"]["ranges"])
    x = _same_on_every_rank(res, "genmf", "x")
    assert _resid(c["coo"], x, c["rhs"]) < RES_TOL
    _close(x, want["x"])
    assert abs(float(_same_on_every_rank(res, "genmf", "logdet"))
               - want["logdet"]) < LOGDET_TOL


def test_complex_factorizations_match_the_port_on_one_device(world):
    # no f64 case of tests/test_parallel.py is complex: the split complex
    # paths (SPLU's K embedding, the GRIDMF and GENMF planes, BCR's complex
    # LU and phase) are held to the port's single-device calls, which the
    # other port tests hold to the reference
    cs, results = world
    res = results()
    want = ranks.run_single(cs)["complex"]
    for name, w in want.items():
        x = _same_on_every_rank([r["complex"] for r in res], name, "x")
        assert np.max(np.abs(x - w["x"])) <= FAC_TOL * (
            1 + np.max(np.abs(w["x"]))), name
        for k in ("logdet", "phase"):
            got = _same_on_every_rank([r["complex"] for r in res], name, k)
            assert abs(complex(got) - complex(w[k])) < LOGDET_TOL, (name, k)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of this process alone and its mesh; left at the end."""
    par.initialize_multihost(device="cpu")
    try:
        yield par.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_rank_results(world_of_one):
    cs = ranks.cases()
    return (ranks.run_dist(world_of_one, cs, 1, 0), ranks.run_single(cs))


def _bit_equal(got, want, path):
    if isinstance(want, dict):
        for k, v in want.items():
            if k != "ranges":
                _bit_equal(got[k], v, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _bit_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("case", ["spmv", "batch", "bcr", "splu", "gridmf",
                                  "genmf", "complex"])
def test_world_of_one_is_single_device_bit_for_bit(one_rank_results, case):
    got, want = one_rank_results
    _bit_equal(got[case], want[case], case)


@pytest.fixture(scope="module")
def f32_results(world_of_one):
    return ranks.run_f32(world_of_one, ranks.cases())


@pytest.mark.parametrize("case", ["splu", "gridmf", "genmf"])
def test_world_of_one_f32_cases(f32_results, reference, world, case):
    # tests/test_parallel.py's float32 cases: f32 factors and x, the world
    # of one the single-device call bit for bit, held at that file's f32
    # bars (an absolute residual of 1e-3, log|det| within 1e-2) and the
    # factors at its f32 tolerance (1e-4, GRIDMF 1e-5, of 1 + max|.|)
    # against the reference's f64 factors
    cs, _ = world
    got, single = f32_results[case]
    _bit_equal(got, single, case)
    want = reference[case]
    assert got["x"].dtype == np.float32
    assert _resid(cs[case]["coo"], got["x"].astype(np.float64),
                  cs[case]["rhs"]) < 1e-3
    assert abs(float(got["logdet"]) - want["logdet"]) < 1e-2
    if case == "splu":
        assert got["f"].dtype == np.float32
        _close(got["f"].astype(np.float64), want["blocks"], 1e-4)
    else:
        for g, w in zip(got["f"], want["sir"]):
            assert g.dtype == np.float32
            _close(g.astype(np.float64), w, 1e-5 if case == "gridmf"
                   else 1e-4)
    if case == "genmf":
        _close(got["x"].astype(np.float64), want["x"], 1e-4)


def test_make_mesh_refusals(world_of_one):
    with pytest.raises(ValueError, match="requested 2 devices"):
        par.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh shape"):
        par.make_mesh(1, shape=(2,), device="cpu")
    with pytest.raises(ValueError, match="axis_names"):
        par.make_mesh(1, axis_names=("a", "b"), device="cpu")
    mesh = par.make_mesh(1, axis_names=("a",), device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        par.dist_splu_factorize(mesh, None, None)


def test_no_card_no_cpu_fallback():
    # this machine has no CUDA device: the default device is the card
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.initialize_multihost()


def test_shard_csr_rows_refuses_triangular_storage():
    _, _, csr, _ = samples.lower_symmetric_5x5("cpu")
    with pytest.raises(ValueError, match="non-triangular"):
        par.shard_csr_rows(csr, 2)


def test_shard_banded_factorize_refuses_the_scan(world_of_one):
    coo = samples.laplacian_2d(8)
    ii, jj, vv = coo.triplets()
    plan = factor.analyze(coo.nrow, ii, jj, genie=Genie.BANDED,
                          banded_kernel="scan")
    with pytest.raises(ValueError, match="BCR"):
        par.shard_banded_factorize(world_of_one, plan, vv)


# a stand-in for nvcc: logs its start, takes a while, writes its -o file
FAKE_NVCC = """#!/bin/sh
echo start >> "$NVCC_LOG"
sleep 0.5
while [ $# -gt 1 ]; do
  [ "$1" = "-o" ] && out="$2"
  shift
done
echo lib > "$out"
"""


def test_ranks_starting_together_build_each_kernel_once(tmp_path):
    # the ranks of a group start on one machine at once: the build lock
    # lets the first compile, and the others find the libraries up to date
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(FAKE_NVCC)
    (bindir / "nvcc").chmod(0o755)
    log = tmp_path / "nvcc.log"
    build = tmp_path / "build"
    code = ("import sys\n"
            "import russell_tpu_torch.sparse._cuda as c\n"
            "c.BUILD_DIR = sys.argv[1]\n"
            "c.build_all(['gj_inv', 'gather_rows'])\n")
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               NVCC_LOG=str(log), PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, cwd=ROOT) for _ in range(3)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0, 0]
    assert log.read_text().split() == ["start", "start"]
    for name in ("gj_inv", "gather_rows"):
        assert (build / f"lib{name}.so").read_text() == "lib\n"
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
