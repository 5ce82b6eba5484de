"""The DENSE path of factor.py in russell_tpu_torch against russell_tpu's,
and the autodiff and numerical Jacobians, on the CPU.

analyze's DENSE plans (AUTO at n <= dense_threshold, with and without a
grid hint, and DENSE itself), the real and complex factors (``lu``,
``piv`` through ``interop``, log|det|, phase, min|pivot|) and the single
and paired solves, on the same inputs (made from a seed with numpy)
through both packages, f64 on the CPU, at rtol 1e-12.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.ode import Method as JMethod, OdeSolver as JOdeSolver
from russell_tpu.ode import Params as JParams, System as JSystem
from russell_tpu.ode import samples as jode_samples
from russell_tpu.sparse import factor as jfactor
from russell_tpu.sparse.numerical_jacobian import (
    jacobian_values as j_jacobian_values,
    numerical_jacobian as j_numerical_jacobian)
from russell_tpu.sparse.enums import Genie as JGenie, Scaling as JScaling
from russell_tpu_torch import interop
from russell_tpu_torch.ode import Method, OdeSolver, Params, System
from russell_tpu_torch.ode import samples as ode_samples
from russell_tpu_torch.sparse import factor as tfactor
from russell_tpu_torch.sparse.numerical_jacobian import (
    jacobian_values, numerical_jacobian)
from russell_tpu_torch.sparse.enums import Genie, Scaling

torch.set_num_threads(2)

RTOL = 1e-12
COUNTERS = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations", "n_iterations_max")


def _counters(st):
    return {k: getattr(st, k) for k in COUNTERS}


def _k_pattern(npoint=4, seed=0):
    """Radau5's K on the npoint Brusselator: Jacobian entries, with the
    Neumann mirror's duplicates, and the mass diagonal, so that up to three
    entries share a slot; real and complex values from a seed."""
    system, _, y0, _ = ode_samples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    jv = system.jacobian(0.0, torch.as_tensor(y0), None).numpy()
    rng = np.random.default_rng(seed)
    jv = jv * (1.0 + 0.05 * rng.standard_normal(len(jv)))
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    vr = np.concatenate([-jv, np.full(n, 3.7)])
    vc = np.concatenate([-jv.astype(np.complex128), np.full(n, 2.7 + 3.1j)])
    return n, rows, cols, vr, vc


@pytest.mark.parametrize("genie,grid,scaling", [
    ("AUTO", None, "AUTO"), ("AUTO", (4, 4, 2), "AUTO"),
    ("DENSE", None, "AUTO"), ("DENSE", None, "MAX")])
def test_analyze_dense_matches_reference(genie, grid, scaling):
    n, rows, cols, *_ = _k_pattern()
    tp = tfactor.analyze(n, rows, cols, genie=Genie[genie], grid=grid,
                         scaling=Scaling[scaling])
    jp = jfactor.analyze(n, rows, cols, genie=JGenie[genie], grid=grid,
                         scaling=JScaling[scaling])
    assert tp.genie == Genie.DENSE and jp.genie == JGenie.DENSE
    assert tp.scaling.value == jp.scaling.value
    assert tp.refine_steps == jp.refine_steps == 0
    assert tp.effective_ordering == jp.effective_ordering == "natural"
    assert tp.pivot_epsilon == jp.pivot_epsilon
    np.testing.assert_array_equal(tp.rows, jp.rows)
    np.testing.assert_array_equal(tp.cols, jp.cols)


def test_dense_passes_sum_in_entry_order():
    n, rows, cols, vr, _ = _k_pattern()
    tp = tfactor.analyze(n, rows, cols)
    slot = rows * n + cols
    assert len(tp.dense_passes) == np.bincount(slot).max() == 3
    seen = np.concatenate([ids for ids, _ in tp.dense_passes])
    np.testing.assert_array_equal(np.sort(seen), np.arange(len(rows)))
    for k, (ids, slots) in enumerate(tp.dense_passes):
        assert len(np.unique(slots)) == len(slots)
        np.testing.assert_array_equal(slots, slot[ids])
        if k:  # each entry comes after its slot's entry of the pass before
            prev = dict(zip(*tp.dense_passes[k - 1][::-1]))
            assert all(prev[s] < i for i, s in zip(ids, slots))
    # the dense matrix: entries summed left to right, as np.add.at does
    a = np.zeros(n * n)
    np.add.at(a, slot, vr)
    fac = tfactor.numeric_factorize(tp, torch.as_tensor(vr))
    lu, piv = torch.linalg.lu_factor_ex(torch.as_tensor(a.reshape(n, n)))[:2]
    torch.testing.assert_close(fac["lu"], lu, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("scaling", ["AUTO", "MAX"])
def test_dense_factors_match_reference(kind, scaling):
    n, rows, cols, vr, vc = _k_pattern(seed=1)
    vals = vr if kind == "real" else vc
    tp = tfactor.analyze(n, rows, cols, scaling=Scaling[scaling])
    jp = jfactor.analyze(n, rows, cols, scaling=JScaling[scaling])
    fac = tfactor.numeric_factorize(tp, torch.as_tensor(vals))
    jfac = jfactor.numeric_factorize(jp, jnp.asarray(vals))
    jnp_fac = {k: np.asarray(v) for k, v in jfac.items()}
    got = interop.dense_factor_to_numpy(fac)
    np.testing.assert_array_equal(got["piv"], jnp_fac["piv"])
    for k in ("lu", "rs", "cs", "data"):
        np.testing.assert_allclose(got[k], jnp_fac[k], rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(jnp_fac[k])))
    for k in ("logdet", "phase", "min_pivot"):
        np.testing.assert_allclose(got[k], jnp_fac[k], rtol=RTOL)
    assert fac["lu"].dtype == (torch.float64 if kind == "real"
                               else torch.complex128)
    # the reference's factor carried over solves like the port's own
    back = interop.dense_factor_to_torch(jnp_fac, "cpu")
    assert back["piv"].dtype == torch.int32
    torch.testing.assert_close(back["piv"], fac["piv"], rtol=0, atol=0)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    torch.testing.assert_close(tfactor.factor_solve(tp, back, b),
                               tfactor.factor_solve(tp, fac, b),
                               rtol=1e-11, atol=0)


def test_logdet_sign_counts_one_based_pivots():
    # a permutation with one swap: det = -2 (torch's pivots are 1-based)
    a = torch.tensor([[0.0, 2.0], [1.0, 0.0]], dtype=torch.float64)
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    logdet, phase = tfactor._logdet_update(torch.diagonal(lu), piv)
    assert float(phase) == -1.0 and abs(float(logdet) - np.log(2.0)) < 1e-15
    singular = torch.tensor([[1.0, 2.0], [2.0, 4.0]], dtype=torch.float64)
    n = 2
    plan = tfactor.analyze(n, np.repeat(np.arange(n), n),
                           np.tile(np.arange(n), n))
    fac = tfactor.numeric_factorize(plan, singular.reshape(-1))
    assert float(fac["min_pivot"]) == 0.0
    assert float(fac["logdet"]) == -np.inf


@pytest.mark.parametrize("refine", [None, 2])
def test_dense_solves_match_reference(refine):
    n, rows, cols, vr, vc = _k_pattern(seed=3)
    scaling = Scaling.MAX if refine else Scaling.AUTO
    tp = tfactor.analyze(n, rows, cols, scaling=scaling)
    jp = jfactor.analyze(n, rows, cols, scaling=JScaling[scaling.name])
    tfr, tfc = tfactor.numeric_factorize_pair(tp, torch.as_tensor(vr),
                                              torch.as_tensor(vc))
    jfr, jfc = jfactor.numeric_factorize_pair(jp, jnp.asarray(vr),
                                              jnp.asarray(vc))
    rng = np.random.default_rng(4)
    br = rng.standard_normal(n)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = tfactor.factor_solve_pair(tp, tfr, tfc, torch.as_tensor(br),
                                    torch.as_tensor(bc), refine_steps=refine)
    want = jfactor.factor_solve_pair(jp, jfr, jfc, jnp.asarray(br),
                                     jnp.asarray(bc), refine_steps=refine)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(w)))
    x = tfactor.factor_solve(tp, tfr, torch.as_tensor(br), refine)
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jfactor.factor_solve(jp, jfr, jnp.asarray(br),
                                                   refine)), rtol=RTOL,
        atol=RTOL * float(x.abs().max()))
    # and both systems are solved
    for v, b, xg in ((vr, br, got[0]), (vc, bc, got[1])):
        ax = np.zeros(n, dtype=v.dtype)
        np.add.at(ax, rows, v * xg.numpy()[cols])
        np.testing.assert_allclose(ax, b, rtol=1e-12, atol=1e-12)


def _rhs_pair():
    # van der Pol (eps 0.1) through both packages' rhs conventions
    def fj(x, y, args):
        return jnp.stack([y[1], ((1.0 - y[0] * y[0]) * y[1] - y[0]) / 0.1])

    def ft(x, y, args):
        return torch.stack([y[1], ((1.0 - y[0] * y[0]) * y[1] - y[0]) / 0.1])

    return fj, ft


def test_numerical_jacobian_matches_reference():
    fj, ft = _rhs_pair()
    y = np.array([1.7, -0.4])
    rows, cols = np.array([0, 1, 1, 0]), np.array([1, 0, 1, 0])
    for alpha in (1.0, -2.5):
        want = np.asarray(j_numerical_jacobian(alpha, 0.3, y, fj, rows,
                                               cols))
        got = numerical_jacobian(alpha, 0.3, y, ft, rows, cols, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)
        want = np.asarray(j_jacobian_values(alpha, 0.3, y, fj, rows, cols))
        got = jacobian_values(alpha, 0.3, torch.as_tensor(y), ft, rows, cols)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("mode", ["autodiff", "numerical"])
def test_system_jacobian_values_match_reference(mode):
    fj, ft = _rhs_pair()
    use_num = mode == "numerical"
    (ii, jj), jac_t = System(2, ft).jac_values_fn(use_num)
    (jii, jjj), jac_j = JSystem(2, fj).jac_values_fn(use_num)
    np.testing.assert_array_equal(ii, jii)
    np.testing.assert_array_equal(jj, jjj)
    for y in (np.array([1.7, -0.4]), np.array([0.0, 3e-7])):
        np.testing.assert_allclose(
            jac_t(0.2, torch.as_tensor(y), None).numpy(),
            np.asarray(jac_j(0.2, jnp.asarray(y), None)), rtol=RTOL,
            atol=1e-15)
    assert System(2, ft).jac_nnz == 4


def test_numerical_jacobian_radau5_matches_reference():
    # tests/test_ode.py:201: n_function counts ndim per Jacobian
    system, x0, y0, x1, args = ode_samples.van_der_pol(1e-3, False)
    jsystem, *_ = jode_samples.van_der_pol(1e-3, False)
    runs = []
    for numerical in (True, False):
        params, jparams = Params(Method.RADAU5), JParams(JMethod.RADAU5)
        params.newton.use_numerical_jacobian = numerical
        jparams.newton.use_numerical_jacobian = numerical
        sol = OdeSolver(params, system, "cpu")
        jsol = JOdeSolver(jparams, jsystem)
        y = sol.solve(y0, x0, 0.2, args=args).numpy()
        yj = np.asarray(jsol.solve(y0, x0, 0.2, args=args))
        assert _counters(sol.stats()) == _counters(jsol.stats())
        np.testing.assert_allclose(y, yj, rtol=1e-10)
        runs.append((y, sol.stats()))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    st_num = runs[0][1]
    assert st_num.n_function >= 2 * st_num.n_jacobian


def test_autodiff_jacobian_radau5_matches_reference():
    # tests/test_ode.py:213: no analytic Jacobian -> torch.func.jacfwd
    fj, ft = _rhs_pair()
    sol = OdeSolver(Params(Method.RADAU5), System(2, ft), "cpu")
    jsol = JOdeSolver(JParams(JMethod.RADAU5), JSystem(2, fj))
    y = sol.solve(np.array([2.0, 0.0]), 0.0, 1.0).numpy()
    yj = np.asarray(jsol.solve(np.array([2.0, 0.0]), 0.0, 1.0))
    assert np.all(np.isfinite(y))
    assert sol.actual.plan.genie == Genie.DENSE
    assert _counters(sol.stats()) == _counters(jsol.stats())
    np.testing.assert_allclose(y, yj, rtol=1e-10)
