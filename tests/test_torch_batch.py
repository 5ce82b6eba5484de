"""A batch of sparse systems over one plan in russell_tpu_torch, on the CPU.

``factor.numeric_factorize`` on entry values (B, nnz) and ``factor_solve``
on right-hand sides (B, n) run one numeric phase over a leading lane
dimension through every sparse genie (GRIDMF, SPLU, GENMF, BANDED), and
``OdeSolver.solve_batch`` runs fused Radau5 lanes through them. Held here,
on Newton matrices and integrations of the npoint-5 Brusselator: each lane
against a single call of the port (the factorization's statistics bit for
bit), GRIDMF and SPLU against the reference's ``jax.vmap`` of its numeric
phase, every genie's ``solve_batch`` lanes against single fused solves and
GRIDMF's against the reference's ``solve_batch``, the single fused run
through BANDED and GENMF against the host-stepped one, the plain
``gj_inv`` with a pivot threshold per matrix, and the refusals.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, samples as jsamples
from russell_tpu.sparse import factor as jfactor
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu.sparse.lin_solver import LinSolParams as JLinSolParams
from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
from russell_tpu_torch.sparse import factor, splu
from russell_tpu_torch.sparse.enums import Genie
from russell_tpu_torch.sparse.lin_solver import LinSolParams

COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")
NPOINT = 5
B = 3
GENIES = {"gridmf": (Genie.GRIDMF, JGenie.GRIDMF),
          "splu": (Genie.SPLU, JGenie.SPLU),
          "genmf": (Genie.GENMF, JGenie.GENMF),
          "banded": (Genie.BANDED, JGenie.BANDED)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls (lu_factor_ex, lu_solve) run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _newton_inputs(seed=3):
    """The npoint-5 Brusselator's pattern (Jacobian and unit mass) and B
    real and complex Newton matrices of it, gamma M - J and (alpha + i
    beta) M - J with J perturbed per lane, with seeded right-hand sides."""
    system, t0, y0, _ = samples.brusselator_pde(2e-3, NPOINT)
    ii, jj = system.jac_structure
    n = system.ndim
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    rng = np.random.default_rng(seed)
    jvs = jv * (1.0 + 0.1 * rng.standard_normal((B, len(jv))))
    g = np.linspace(30.0, 50.0, B)[:, None] * np.ones((1, n))
    vr = np.concatenate([-jvs, g], axis=1)
    vc = np.concatenate([-jvs + 0j, (0.9 * g) + 1j * (0.7 * g)], axis=1)
    br = rng.standard_normal((B, n))
    bc = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    return system, n, rows, cols, vr, vc, br, bc


def _plan(genie, n, rows, cols, grid, ref=False):
    mod, g = (jfactor, GENIES[genie][1]) if ref else (factor,
                                                      GENIES[genie][0])
    kw = {"grid": grid} if genie == "gridmf" else {}
    return mod.analyze(n, rows, cols, genie=g, dense_threshold=8, **kw)


def _x_close(got, want):
    # torch's CPU bmm takes another BLAS path for a batch of one matrix (a
    # single lane's root front or pivot block) than for several, and rounds
    # the products apart: the solutions then differ in the last bits
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= 1e-14 * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("genie", list(GENIES))
def test_batched_factorization_equals_single_calls(genie, kind):
    system, n, rows, cols, vr, vc, br, bc = _newton_inputs()
    plan = _plan(genie, n, rows, cols, system.grid)
    assert plan.genie == GENIES[genie][0]
    vals, rhs = (vr, br) if kind == "real" else (vc, bc)
    fb = factor.numeric_factorize(plan, torch.as_tensor(vals))
    xb = factor.factor_solve(plan, fb, torch.as_tensor(rhs))
    assert xb.shape == (B, n) and fb["logdet"].shape == (B,)
    for lane in range(B):
        f1 = factor.numeric_factorize(plan, torch.as_tensor(vals[lane]))
        x1 = factor.factor_solve(plan, f1, torch.as_tensor(rhs[lane]))
        for k in ("logdet", "min_pivot", "n_perturbed"):
            assert torch.equal(fb[k][lane], f1[k]), (k, lane)
        if kind == "real":
            assert torch.equal(fb["phase"][lane], f1["phase"]), lane
        _x_close(xb[lane], x1)
    # the pair forms (Radau5's) take the same batches
    fr, fc = factor.numeric_factorize_pair(plan, torch.as_tensor(vr),
                                           torch.as_tensor(vc))
    xr, xc = factor.factor_solve_pair(plan, fr, fc, torch.as_tensor(br),
                                      torch.as_tensor(bc), refine_steps=0)
    f1r, f1c = factor.numeric_factorize_pair(plan, torch.as_tensor(vr[1]),
                                             torch.as_tensor(vc[1]))
    x1r, x1c = factor.factor_solve_pair(plan, f1r, f1c, torch.as_tensor(br[1]),
                                        torch.as_tensor(bc[1]),
                                        refine_steps=0)
    _x_close(xr[1], x1r)
    _x_close(xc[1], x1c)


@pytest.mark.parametrize("genie,kind", [("gridmf", "real"),
                                        ("splu", "complex")])
def test_batched_factorization_matches_reference_vmap(genie, kind):
    # the reference's batch: jax.vmap of numeric_factorize and factor_solve
    # (``one`` of russell_tpu/parallel/batch.py:45-47); one kind a genie,
    # as each kind is a program XLA compiles apart (4-9 s each on a CPU),
    # and the other kind of each genie is held to single calls above
    system, n, rows, cols, vr, vc, br, bc = _newton_inputs(seed=5)
    vals, rhs = (vr, br) if kind == "real" else (vc, bc)
    tp = _plan(genie, n, rows, cols, system.grid)
    jp = _plan(genie, n, rows, cols, system.grid, ref=True)

    def one(v, b):
        f = jfactor.numeric_factorize(jp, v)
        return jfactor.factor_solve(jp, f, b), f["logdet"], f["n_perturbed"]

    jx, jld, jnp_ = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(vals), jnp.asarray(rhs)))
    f = factor.numeric_factorize(tp, torch.as_tensor(vals))
    x = factor.factor_solve(tp, f, torch.as_tensor(rhs))
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(f["logdet"].numpy(), jld, rtol=1e-12,
                               atol=1e-12)
    assert f["n_perturbed"].tolist() == jnp_.tolist()


def _brusselator(genie, npoint=NPOINT):
    system, t0, y0, _ = samples.brusselator_pde(2e-3, npoint)
    params = Params(Method.RADAU5)
    params.newton.lin_sol_params = LinSolParams(dense_threshold=8)
    if genie != "gridmf":   # GRIDMF is AUTO's route with the grid hint
        params.newton.genie = GENIES[genie][0]
    return system, t0, np.asarray(y0), params


def _spread(y0):
    """B initial states apart enough to take different step counts."""
    y0s = np.tile(y0[None], (B, 1))
    y0s[:, 0] += np.linspace(0.0, 2.0, B)
    y0s[:, -1] *= np.linspace(1.0, 3.0, B)
    return y0s


# a short span keeps SPLU's per-step assembly (its plan's 1,024-lane row
# window of 64 x 64 blocks, per matrix) within the file's time budget; the
# lanes take 4, 4 and 5 accepted steps (6 attempts) to it
X1 = 0.02


@pytest.mark.parametrize("genie", list(GENIES))
def test_solve_batch_lanes_equal_single_fused_solves(genie):
    system, t0, y0, params = _brusselator(genie)
    sol = OdeSolver(params, system, "cpu")
    y0s = _spread(y0)
    ys, st = sol.solve_batch(y0s, t0, X1)
    assert sol.actual.plan.genie == GENIES[genie][0]
    assert st["status"].tolist() == [1] * B
    assert len(set(st["n_accepted"].tolist())) > 1
    for lane in range(B):
        y = sol.solve(y0s[lane], t0, X1, fused=True)
        np.testing.assert_allclose(ys[lane].numpy(), y.numpy(), rtol=0,
                                   atol=1e-12)
        assert ({k: int(st[k][lane]) for k in COUNTERS}
                == {k: getattr(sol.stats(), k) for k in COUNTERS}), lane
    if genie != "gridmf":
        return
    # GRIDMF's lanes against the reference's solve_batch (jax.vmap of its
    # fused Radau5 through GRIDMF)
    jsystem, t0, _, _ = jsamples.brusselator_pde(2e-3, NPOINT)
    jparams = JParams(JMethod.RADAU5)
    jparams.newton.lin_sol_params = JLinSolParams(dense_threshold=8)
    jy, jst = JOdeSolver(jparams, jsystem).solve_batch(y0s, t0, X1)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-12)
    for k in COUNTERS:
        assert st[k].tolist() == np.asarray(jst[k]).tolist(), k


@pytest.mark.parametrize("genie", ["banded", "genmf"])
def test_fused_single_lane_matches_host(genie):
    system, t0, y0, params = _brusselator(genie)
    host = OdeSolver(params, system, "cpu")
    yh = host.solve(y0, t0, 0.2)
    fused = OdeSolver(params, system, "cpu")
    yf = fused.solve(y0, t0, 0.2, fused=True)
    assert fused.actual.plan.genie == GENIES[genie][0]
    assert ({k: getattr(fused.stats(), k) for k in COUNTERS}
            == {k: getattr(host.stats(), k) for k in COUNTERS})
    assert torch.equal(yf, yh)


def test_gj_inv_plain_takes_a_delta_per_matrix():
    rng = np.random.default_rng(8)
    w, m = 4, 6
    D = rng.standard_normal((B * w, m, m)) + 2.0 * np.eye(m)
    D[0, 0, 0] = 0.0          # a zero pivot clamped by every threshold
    D[w + 1, 2, :] = 1e-9     # a pivot below the second matrix's only
    D[w + 1, :, 2] = 1e-9
    delta = torch.tensor([1e-12, 1e-6, 1e-12], dtype=torch.float64)
    Dt = torch.as_tensor(D)
    got = splu._gj_inv_plain(Dt, delta)
    for lane in range(B):
        want = splu._gj_inv_plain(Dt[lane * w:(lane + 1) * w], delta[lane])
        for g, x in zip(got, want):
            assert torch.equal(g[lane * w:(lane + 1) * w], x), lane
    assert got[3].tolist() == [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0]
    # the wrapper takes the same form on the CPU; the thresholds must
    # split the lanes
    assert all(torch.equal(a, b) for a, b in zip(splu._gj_inv(Dt, delta),
                                                  got))
    with pytest.raises(ValueError, match="do not split"):
        splu._gj_inv_plain(Dt[:5], delta)


def test_batch_refusals():
    system, n, rows, cols, vr, vc, br, bc = _newton_inputs()
    plan = _plan("gridmf", n, rows, cols, system.grid)
    one = factor.numeric_factorize(plan, torch.as_tensor(vr[0]))
    with pytest.raises(ValueError, match=r"\(3, 50\).*one matrix"):
        factor.factor_solve(plan, one, torch.as_tensor(br))
    batch = factor.numeric_factorize(plan, torch.as_tensor(vr))
    with pytest.raises(ValueError, match=r"\(50,\).*batch of 3"):
        factor.factor_solve(plan, batch, torch.as_tensor(br[0]))
    with pytest.raises(ValueError, match="one matrix"):
        factor.det_phase(plan, batch)
    assert factor.det_phase(plan, one) == complex(one["phase"])
    with pytest.raises(ValueError):
        factor.numeric_factorize(plan, torch.zeros((2, 2, len(rows)),
                                                   dtype=torch.float64))


class _Split:
    """A stand-in ``split`` of one rank: a batch is refused before it is
    used."""

    def block(self, n):
        return (0, n)


@pytest.mark.parametrize("genie", ["gridmf", "genmf", "banded"])
def test_batch_with_split_is_refused(genie):
    from russell_tpu_torch.sparse import bcr, genmf, gridmf
    system, n, rows, cols, vr, *_ = _newton_inputs()
    data = torch.as_tensor(vr)
    if genie == "banded":
        plan = factor.analyze(n, rows, cols, genie=Genie.BANDED,
                              banded_kernel="bcr")
        blocks = factor._banded_scatter(plan, data)
        with pytest.raises(ValueError, match="split"):
            bcr.bcr_factorize(blocks[:, 1], blocks[:, 0], blocks[:, 2],
                              split=_Split())
        return
    plan = _plan(genie, n, rows, cols, system.grid)
    fn = (gridmf.gridmf_factorize if genie == "gridmf"
          else genmf.genmf_factorize)
    sub = plan.gridmf_plan if genie == "gridmf" else plan.genmf_plan
    with pytest.raises(ValueError, match="split"):
        fn(sub, data, split=_Split())
