"""stat/ and tensor/ of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_stat_tensor.py`` is the checklist (its 18 cases each have a
counterpart here). The same seeded numpy inputs go through both packages
(carried across by ``interop.tensor2_from`` / ``tensor4_from`` /
``distribution_from``); the port computes on ``device="cpu"``.

Tolerances:
- ``pdf``, ``cdf``, ``mean`` and ``variance``: rtol 1e-13 against the
  reference (and scipy.stats as the reference's own tests hold it);
- sampling: the streams differ from ``jax.random``'s, so each package's
  2^16 draws are held by their moments (within 6 standard errors of
  ``mean()`` and ``variance()``) and the KS statistic against ``cdf``
  (under 1.95/sqrt(n)), and the two packages' draws to each other by the
  two-sample KS statistic (under 1.95 sqrt(2/n));
- ``Statistics``, quantiles, outliers and ``Histogram``: host numpy in both
  packages, equal results and text;
- tensor functions: |port - reference| <= 1e-13 max|reference| (the
  result's largest entry): the 3x3 ``inv``/``det`` are LAPACK's here and
  XLA's there, and entries that cancel (an inverse's, J3's) amplify that
  roundoff entry by entry (up to ~1e-12 relative), not in norm (~2e-14);
- eigen results: eigenvalues, and the projectors where the eigenvalue gap
  exceeds 1e-6 |T| (eigenvectors may differ in sign); composed tensors;
- ``torch.func.vmap`` against ``jax.vmap`` over 8 tensors for each
  function the reference batches, and against the port's per-tensor calls
  (a batched matmul sums in another order than a single one), at the
  tensor tolerance.

``LinElasticity.calc_compliance`` under plane stress inverts a singular
D (its zz row is zero): the reference returns non-finite values, the port
raises ``torch.linalg.LinAlgError``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as ss
from scipy.linalg import expm

from chip_smoke import fourth_central
import russell_tpu.stat as jstat
import russell_tpu.tensor as jt
import russell_tpu_torch.stat as pstat
import russell_tpu_torch.tensor as pt
from russell_tpu_torch import interop

CPU = "cpu"
N_DRAWS = 1 << 16
KS_C = 1.95         # the KS statistic's bound at alpha ~ 0.001, times sqrt(n)
TENSOR_RTOL = 1e-13


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _tclose(got, want, rtol=TENSOR_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (got, want)


# ---------------------------- stat ------------------------------------------

# (reference distribution, the x range of the pdf/cdf points, scipy frozen)
DISTRIBUTIONS = {
    "frechet": (jstat.DistributionFrechet(8.782275, 1.0, 6.0), (8.0, 14.0),
                ss.invweibull(6.0, loc=8.782275, scale=1.0)),
    "gumbel": (jstat.DistributionGumbel(1.0, 2.0), (-4.0, 10.0),
               ss.gumbel_r(1.0, 2.0)),
    "lognormal": (jstat.DistributionLognormal(0.5, 0.25), (0.3, 5.0),
                  ss.lognorm(0.25, scale=math.exp(0.5))),
    "normal": (jstat.DistributionNormal(2.0, 3.0), (-5.0, 9.0),
               ss.norm(2.0, 3.0)),
    "uniform": (jstat.DistributionUniform(1.0, 3.0), (0.5, 3.5),
                ss.uniform(1.0, 2.0)),
}


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_distribution_pdf_cdf_mean_variance(name):
    jd, (lo, hi), sd = DISTRIBUTIONS[name]
    pd = interop.distribution_from(jd)
    assert type(pd).__name__ == type(jd).__name__
    xs = np.sort(np.random.default_rng(7).uniform(lo, hi, 257))
    for f in ("pdf", "cdf"):
        got = getattr(pd, f)(xs, device=CPU)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(
            getattr(jd, f)(xs)), rtol=1e-13, atol=0)
        np.testing.assert_allclose(got.numpy(), getattr(sd, f)(xs),
                                   rtol=0, atol=1e-12)
        # a tensor computes on its device; a float on device=
        t = torch.as_tensor(xs)
        assert torch.equal(getattr(pd, f)(t), got)
        assert getattr(pd, f)(float(xs[3]), device=CPU).item() == got[3]
    assert pd.mean() == pytest.approx(jd.mean(), rel=1e-13)
    assert pd.variance() == pytest.approx(jd.variance(), rel=1e-13)
    assert pd.mean() == pytest.approx(sd.mean(), rel=1e-12)
    assert pd.variance() == pytest.approx(sd.var(), rel=1e-12)


def _moments_and_ks(draws, d, n, cdf):
    var = d.variance()
    mean_se = math.sqrt(var / n)
    var_se = math.sqrt((fourth_central(d) - var ** 2) / n)
    assert abs(float(np.mean(draws)) - d.mean()) < 6 * mean_se
    assert abs(float(np.var(draws, ddof=1)) - var) < 6 * var_se
    u = np.sort(np.asarray(cdf(np.sort(draws)), dtype=np.float64))
    i = np.arange(1, n + 1)
    ks = max(np.max(i / n - u), np.max(u - (i - 1) / n))
    assert ks < KS_C / math.sqrt(n)


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_distribution_sampling(name):
    jd = DISTRIBUTIONS[name][0]
    pd = interop.distribution_from(jd)
    g = torch.Generator(CPU)
    g.manual_seed(13)
    draws = pd.sample(g, (N_DRAWS,))
    assert draws.dtype == torch.float64 and draws.shape == (N_DRAWS,)
    assert torch.isfinite(draws).all()
    _moments_and_ks(draws.numpy(), pd, N_DRAWS,
                    lambda x: pd.cdf(x, device=CPU))
    jdraws = np.asarray(jd.sample(jax.random.PRNGKey(13), (N_DRAWS,)))
    _moments_and_ks(jdraws, jd, N_DRAWS, jd.cdf)
    assert ss.ks_2samp(draws.numpy(), jdraws).statistic < KS_C * math.sqrt(
        2.0 / N_DRAWS)
    # the same seed gives the same bits; a scalar for shape ()
    g.manual_seed(13)
    assert torch.equal(pd.sample(g, N_DRAWS), draws)
    assert pd.sample(g).shape == ()


def test_distribution_constructors_and_edges():
    for jd in (jstat.DistributionGumbel.new_from_mu_sig(5.0, 2.0),
               jstat.DistributionLognormal.new_from_mu_sig(2.0, 0.5)):
        pd = getattr(pstat, type(jd).__name__).new_from_mu_sig(5.0, 2.0) \
            if isinstance(jd, jstat.DistributionGumbel) else \
            pstat.DistributionLognormal.new_from_mu_sig(2.0, 0.5)
        assert pd.mean() == jd.mean() and pd.variance() == jd.variance()
    # distribution_frechet.rs:327's oracle, and the infinite moments
    d = pstat.DistributionFrechet(8.782275, 1.0, 4.095645)
    assert d.mean() == pytest.approx(10.0, abs=1e-6)
    assert d.variance() == pytest.approx(0.25, abs=1e-6)
    d2 = pstat.DistributionFrechet(8.782275, 1.0, 1.0)
    assert d2.mean() == math.inf and d2.variance() == math.inf
    assert d.pdf(8.0, device=CPU).item() == 0.0
    assert d.cdf(8.0, device=CPU).item() == 0.0
    u = pstat.DistributionUniform(1.0, 3.0)
    assert u.pdf(2.0, device=CPU).item() == 0.5
    assert u.pdf(0.0, device=CPU).item() == 0.0
    assert u.pdf([0.0, 2.0], device=CPU).dtype == torch.float64
    ln = pstat.DistributionLognormal(0.5, 0.25)
    assert ln.pdf(-1.0, device=CPU).item() == 0.0
    if not torch.cuda.is_available():      # a float goes to the card
        with pytest.raises(RuntimeError):
            ln.cdf(1.0)
    for bad in (lambda: pstat.DistributionFrechet(0.0, 0.0, 1.0),
                lambda: pstat.DistributionGumbel(0.0, -1.0),
                lambda: pstat.DistributionLognormal(0.0, 0.0),
                lambda: pstat.DistributionNormal(0.0, 0.0),
                lambda: pstat.DistributionUniform(1.0, 1.0),
                lambda: pstat.DistributionLognormal.new_from_mu_sig(0.0,
                                                                    1.0)):
        with pytest.raises(ValueError):
            bad()


def test_statistics_quantiles_outliers_equal_the_reference():
    rng = np.random.default_rng(3)
    for data in ([1.0, 2.0, 3.0, 4.0, 5.0, 100.0], rng.standard_t(3, 1001),
                 [4.0], []):
        for x in (data, torch.as_tensor(np.asarray(data, dtype=np.float64))):
            st, jst = pstat.Statistics(x), jstat.Statistics(data)
            assert (st.min, st.max, st.mean, st.std_dev) == (
                jst.min, jst.max, jst.mean, jst.std_dev)
            assert str(st) == str(jst)
            if len(data) == 0:
                continue
            assert pstat.quartiles(x) == jstat.quartiles(data)
            assert pstat.inter_quartile_range(x) == \
                jstat.inter_quartile_range(data)
            assert pstat.outliers(x) == jstat.outliers(data)
            srt = np.sort(np.asarray(data, dtype=np.float64))
            for q in (0.0, 0.1, 0.5, 0.9, 1.0):
                assert pstat.quantile(srt, q) == jstat.quantile(srt, q)
    assert pstat.outliers([1.0, 2.0, 3.0, 4.0, 5.0, 100.0]) == [(5, 100.0)]
    # ties keep their index order, as the reference's stable loop does
    tied = [0.0] * 8 + [9.0, -9.0, 9.0, -9.0]
    assert pstat.outliers(tied) == jstat.outliers(tied) == [
        (9, -9.0), (11, -9.0), (8, 9.0), (10, 9.0)]
    with pytest.raises(ValueError):
        pstat.quantile([], 0.5)
    with pytest.raises(ValueError):
        pstat.quantile([1.0], 1.5)


def test_histogram_equals_the_reference():
    rng = np.random.default_rng(5)
    data = rng.standard_normal(2000)
    stations = np.linspace(-3.0, 3.0, 21)
    h, jh = pstat.Histogram(stations), jstat.Histogram(stations)
    h.count(torch.as_tensor(data))
    jh.count(data)
    np.testing.assert_array_equal(h.get_counts(), jh.get_counts())
    h.set_bar_char("*").set_bar_max_len(30).set_scientific_fmt_precision(3)
    jh.set_bar_char("*").set_bar_max_len(30).set_scientific_fmt_precision(3)
    assert h.draw() == jh.draw()
    # the checklist's case: [s_i, s_i+1) bins, values outside ignored
    h3 = pstat.Histogram([0.0, 1.0, 2.0, 3.0])
    h3.count([0.5, 0.6, 1.5, 2.5, 2.6, 2.7, 5.0, -1.0, 3.0])
    np.testing.assert_array_equal(h3.get_counts(), [2, 1, 3])
    assert "|" in str(h3) and "#" in str(h3)
    h3.reset()
    np.testing.assert_array_equal(h3.get_counts(), [0, 0, 0])
    for bad in ([1.0], [0.0, 0.0, 1.0]):
        with pytest.raises(ValueError):
            pstat.Histogram(bad)


# ---------------------------- tensor ----------------------------------------

def _sym(rng, mandel="SYMMETRIC"):
    """A seeded tensor of ``mandel`` in both packages."""
    jtt = jt.Tensor2(jt.Mandel[mandel],
                     rng.standard_normal(jt.Mandel[mandel].dim()))
    return jtt, interop.tensor2_from(jtt, CPU)


def _sample_sym():
    m = np.array([[2.0, 1.0, 0.5], [1.0, 3.0, -0.2], [0.5, -0.2, 1.5]])
    return (jt.Tensor2.from_matrix(m, jt.Mandel.SYMMETRIC),
            pt.Tensor2.from_matrix(m, pt.Mandel.SYMMETRIC, CPU), m)


def test_tensor2_roundtrip_and_devices():
    _, t, m = _sample_sym()
    assert t.vec.dtype == torch.float64 and t.device.type == "cpu"
    _tclose(t.as_matrix(), m)
    g = np.array([[1.0, 2.0, 0.0], [3.0, 4.0, 0.5], [0.1, 0.2, 5.0]])
    tg = pt.Tensor2.from_matrix(g, pt.Mandel.GENERAL, CPU)
    jg = jt.Tensor2.from_matrix(g, jt.Mandel.GENERAL)
    _tclose(tg.vec, jg.vec)
    _tclose(tg.as_matrix(), g)
    _tclose(tg.transpose().as_matrix(), g.T)
    _tclose(tg.sym_part().vec, jg.sym_part().vec)
    assert tg.get(1, 0) == jg.get(1, 0)
    with pytest.raises(ValueError):
        pt.Tensor2.from_matrix(g, pt.Mandel.SYMMETRIC, CPU)
    with pytest.raises(ValueError):
        pt.Tensor2.from_matrix(m, pt.Mandel.SYMMETRIC_2D, CPU)
    with pytest.raises(ValueError):
        pt.Tensor2(pt.Mandel.SYMMETRIC, np.zeros(4), CPU)
    # a tensor keeps its device, numpy and nothing go to device=
    v = torch.ones(6, dtype=torch.float64)
    assert pt.Tensor2(pt.Mandel.SYMMETRIC, v).vec is v
    for t in (pt.Tensor2.new(pt.Mandel.GENERAL, CPU),
              pt.Tensor2.new_sym(True, CPU), pt.Tensor4.new(
                  pt.Mandel.SYMMETRIC, CPU),
              pt.Tensor4.p_dev(pt.Mandel.SYMMETRIC_2D, CPU)):
        assert t.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pt.Tensor2.identity(pt.Mandel.SYMMETRIC)


INVARIANTS = ("trace", "invariant_ii1", "invariant_ii2", "invariant_ii3",
              "determinant", "invariant_jj2", "invariant_jj3",
              "invariant_sigma_m", "invariant_sigma_d", "invariant_eps_v",
              "invariant_eps_d", "invariant_lode", "octahedral_distance",
              "octahedral_radius")


@pytest.mark.parametrize("mandel", ["SYMMETRIC", "SYMMETRIC_2D", "GENERAL"])
def test_tensor2_invariants_and_algebra(mandel):
    rng = np.random.default_rng(11)
    for _ in range(2):
        jtt, ptt = _sym(rng, mandel)
        for name in INVARIANTS:
            _tclose(getattr(ptt, name)(), getattr(jtt, name)())
        for name in ("inverse", "squared", "deviator", "transpose",
                     "sym_part", "clone"):
            got, want = getattr(ptt, name)(), getattr(jtt, name)()
            assert got.mandel.name == want.mandel.name
            _tclose(got.vec, want.vec)
        _tclose(ptt.scale(-2.5).vec, jtt.scale(-2.5).vec)
        _tclose(ptt.as_matrix(), jtt.as_matrix())
        assert ptt.norm() == pytest.approx(jtt.norm(), rel=1e-15)
    # the checklist's oracles
    _, t, m = _sample_sym()
    assert t.invariant_ii3().item() == pytest.approx(np.linalg.det(m))
    s = m - np.trace(m) / 3.0 * np.eye(3)
    assert t.invariant_jj3().item() == pytest.approx(np.linalg.det(s))
    assert t.norm() == pytest.approx(np.linalg.norm(m))
    assert -1.0 <= t.invariant_lode().item() <= 1.0
    dev = t.deviator()
    assert abs(dev.trace().item()) < 1e-14
    assert torch.equal(t.vec, torch.as_tensor(pt.Tensor2.from_matrix(
        m, pt.Mandel.SYMMETRIC, CPU).vec))   # the deviator wrote nothing
    z = pt.Tensor2(pt.Mandel.SYMMETRIC, np.zeros(6), CPU)
    assert math.isnan(z.invariant_lode().item())


def test_tensor4_and_operations_equal_the_reference():
    rng = np.random.default_rng(17)
    for mandel in ("SYMMETRIC", "SYMMETRIC_2D", "GENERAL"):
        jm, pm = jt.Mandel[mandel], pt.Mandel[mandel]
        for name in ("identity", "ii_dyad_ii", "p_iso", "p_sym", "p_skew",
                     "p_dev"):
            got = getattr(pt.Tensor4, name)(pm, CPU)
            _tclose(got.mat, getattr(jt.Tensor4, name)(jm).mat)
        _tclose(got.as_matrix_9x9(), jt.Tensor4.p_dev(jm).as_matrix_9x9())
        (ja, pa), (jb, pb) = _sym(rng, mandel), _sym(rng, mandel)
        jd = jt.Tensor4(jm, rng.standard_normal((jm.dim(), jm.dim())))
        pd = interop.tensor4_from(jd, CPU)
        je = jt.Tensor4(jm, rng.standard_normal((jm.dim(), jm.dim())))
        pe = interop.tensor4_from(je, CPU)
        _tclose(pt.t2_ddot_t2(pa, pb), jt.t2_ddot_t2(ja, jb))
        _tclose(pt.t2_dot_t2(pa, pb).vec, jt.t2_dot_t2(ja, jb).vec)
        _tclose(pt.t2_dyad_t2(1.5, pa, pb).mat, jt.t2_dyad_t2(1.5, ja, jb).mat)
        _tclose(pt.t4_ddot_t2(0.5, pd, pa).vec, jt.t4_ddot_t2(0.5, jd, ja).vec)
        _tclose(pt.t2_ddot_t4(0.5, pa, pd).vec, jt.t2_ddot_t4(0.5, ja, jd).vec)
        _tclose(pt.t4_ddot_t4(2.0, pd, pe).mat, jt.t4_ddot_t4(2.0, jd, je).mat)
        _tclose(pt.t2_add(1.5, pa, -0.5, pb).vec,
                jt.t2_add(1.5, ja, -0.5, jb).vec)
        _tclose(pt.t4_add(1.5, pd, -0.5, pe).mat,
                jt.t4_add(1.5, jd, -0.5, je).mat)
        if mandel != "GENERAL":
            # qsd (odyad + udyad) at 3-D also runs in the derivatives' and
            # the vmap tests
            for f in (("t2_odyad_t2", "t2_udyad_t2") if mandel == "SYMMETRIC"
                      else ("t2_qsd_t2",)):
                got = getattr(pt, f)(0.7, pa, pb)
                assert got.mandel == pm
                _tclose(got.mat, getattr(jt, f)(0.7, ja, jb).mat)
        with pytest.raises(ValueError):
            pt.t2_ddot_t2(pa, pt.Tensor2(pt.Mandel.GENERAL, device=CPU)
                          if mandel != "GENERAL" else
                          pt.Tensor2(pt.Mandel.SYMMETRIC, device=CPU))
    # the checklist's contractions
    a, t, ma = _sample_sym()
    pdev = pt.Tensor4.p_dev(pt.Mandel.SYMMETRIC, CPU)
    _tclose(pt.t4_ddot_t2(1.0, pdev, t).as_matrix(), t.deviator().as_matrix())
    ii = pt.Tensor2.identity(pt.Mandel.SYMMETRIC, CPU)
    _tclose(pt.t4_ddot_t2(1.0, pt.t2_dyad_t2(1.0, ii, ii), t).as_matrix(),
            np.trace(ma) * np.eye(3))
    psym = pt.Tensor4.p_sym(pt.Mandel.SYMMETRIC, CPU)
    _tclose(pt.t4_ddot_t4(1.0, pdev, psym).mat, pdev.mat)


DERIVS = ("deriv1_invariant_ii1", "deriv1_invariant_ii2",
          "deriv1_invariant_jj2", "deriv1_invariant_jj3",
          "deriv1_invariant_sigma_m", "deriv1_invariant_sigma_d",
          "deriv1_invariant_lode", "deriv2_invariant_jj2",
          "deriv2_invariant_jj3", "deriv_inverse_tensor",
          "deriv_squared_tensor")


@pytest.mark.parametrize("mandel", ["SYMMETRIC", "SYMMETRIC_2D", "GENERAL"])
def test_derivatives_equal_the_reference(mandel):
    rng = np.random.default_rng(19)
    names = DERIVS if mandel != "GENERAL" else (
        "deriv1_invariant_ii1", "deriv1_invariant_ii2",
        "deriv_inverse_tensor", "deriv_squared_tensor")
    for _ in range(2 if mandel == "SYMMETRIC" else 1):
        jtt, ptt = _sym(rng, mandel)
        for name in names:
            got, want = getattr(pt, name)(ptt), getattr(jt, name)(jtt)
            assert got.mandel.name == want.mandel.name
            _tclose(got.vec if hasattr(got, "vec") else got.mat,
                    want.vec if hasattr(want, "vec") else want.mat)


def test_derivatives_vs_autodiff_and_finite_differences():
    _, t, _ = _sample_sym()
    for name, inv in (("deriv1_invariant_jj2", "invariant_jj2"),
                      ("deriv1_invariant_jj3", "invariant_jj3")):
        v = t.vec.clone().requires_grad_()
        g, = torch.autograd.grad(getattr(
            pt.Tensor2(pt.Mandel.SYMMETRIC, v), inv)(), v)
        _tclose(getattr(pt, name)(t).vec, g, rtol=1e-12)
    dinv = pt.deriv_inverse_tensor(t)
    dsq = pt.deriv_squared_tensor(t)
    h = 1e-7
    for k in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[k] = h
        tp_, tm_ = (pt.Tensor2(pt.Mandel.SYMMETRIC, t.vec + e),
                    pt.Tensor2(pt.Mandel.SYMMETRIC, t.vec - e))
        np.testing.assert_allclose(
            dinv.mat[:, k].numpy(),
            ((tp_.inverse().vec - tm_.inverse().vec) / (2 * h)).numpy(),
            atol=1e-6)
        np.testing.assert_allclose(
            dsq.mat[:, k].numpy(),
            ((tp_.squared().vec - tm_.squared().vec) / (2 * h)).numpy(),
            atol=1e-6)


def test_lin_elasticity_equals_the_reference():
    for kw in ({}, {"two_dim": True}, {"plane_stress": True}):
        jle = jt.LinElasticity(210e3, 0.3, **kw)
        ple = pt.LinElasticity(210e3, 0.3, device=CPU, **kw)
        _tclose(ple.get_modulus().mat, jle.get_modulus().mat)
        if kw.get("plane_stress"):
            assert not np.isfinite(np.asarray(
                jle.calc_compliance().mat)).all()
            with pytest.raises(torch.linalg.LinAlgError):
                ple.calc_compliance()
        else:
            _tclose(ple.calc_compliance().mat, jle.calc_compliance().mat)
            _tclose(ple.calc_compliance().mat @ ple.dd.mat,
                    np.eye(ple.mandel.dim()), rtol=1e-12)
        assert ple.get_bulk_modulus() == jle.get_bulk_modulus()
        assert ple.get_shear_modulus() == jle.get_shear_modulus()
        eps = jt.Tensor2(jle.mandel, np.random.default_rng(23)
                         .standard_normal(jle.mandel.dim()) * 1e-3)
        sig = ple.calc_stress(interop.tensor2_from(eps, CPU))
        _tclose(sig.vec, jle.calc_stress(eps).vec)
        if kw.get("plane_stress"):
            assert ple.out_of_plane_strain(sig) == pytest.approx(
                jle.out_of_plane_strain(jle.calc_stress(eps)), rel=1e-13)
        else:
            with pytest.raises(ValueError):
                ple.out_of_plane_strain(sig)
        ple.set_young_poisson(3000.0, 0.2)
        jle.set_young_poisson(3000.0, 0.2)
        _tclose(ple.dd.mat, jle.dd.mat)
        assert ple.dd.device.type == "cpu"
    with pytest.raises(ValueError):
        pt.LinElasticity(1.0, 0.2, device=CPU).calc_stress(
            pt.Tensor2(pt.Mandel.SYMMETRIC_2D, device=CPU))


def _projectors(sp):
    return np.stack([_np(p.vec) for p in sp.projectors])


def _hold_spectral(psp, jsp, tt):
    """Eigenvalues; projectors where the gaps exceed 1e-6 |T|; the
    composed tensors."""
    lam, jlam = _np(psp.lambdas), _np(jsp.lambdas)
    _tclose(lam, jlam)
    norm = float(np.max(np.abs(_np(tt.vec))))
    gaps = np.diff(lam)
    for i in range(3):
        near = [abs(lam[i] - lam[j]) for j in range(3) if j != i]
        if min(near) > 1e-6 * norm:
            _tclose(_projectors(psp)[i], _projectors(jsp)[i], rtol=1e-12)
    assert gaps.min() >= 0.0
    _tclose(psp.compose(psp.lambdas).vec, jsp.compose(jsp.lambdas).vec,
            rtol=1e-12)
    _tclose(psp.compose(psp.lambdas).vec, tt.vec, rtol=1e-12)


def test_spectral2_equals_the_reference():
    rng = np.random.default_rng(29)
    for two_dim, mandel in ((False, "SYMMETRIC"), (True, "SYMMETRIC_2D")):
        for _ in range(3):
            jtt, ptt = _sym(rng, mandel)
            psp = pt.Spectral2(two_dim, CPU).decompose(ptt)
            jsp = jt.Spectral2(two_dim).decompose(jtt)
            _hold_spectral(psp, jsp, ptt)
        # repeated eigenvalues: the projectors are not unique, the
        # composition is
        rep = pt.Tensor2(pt.Mandel[mandel], [2.0, 2.0, 5.0] + [0.0] * (
            pt.Mandel[mandel].dim() - 3), CPU)
        back = pt.Spectral2(two_dim, CPU).decompose(rep)
        _tclose(back.compose(back.lambdas).vec, rep.vec)
    a, t, m = _sample_sym()
    sp = pt.Spectral2(device=CPU).decompose(t)
    np.testing.assert_allclose(np.sort(sp.lambdas.numpy()),
                               np.linalg.eigvalsh(m), atol=1e-12)
    _tclose(sp.compose(torch.exp(sp.lambdas)).as_matrix(), expm(m),
            rtol=1e-12)
    with pytest.raises(ValueError):
        pt.Spectral2(device=CPU).decompose(pt.Tensor2(pt.Mandel.GENERAL,
                                                      device=CPU))
    with pytest.raises(ValueError):
        pt.Spectral2(True, CPU).decompose(t)


def test_vec_dyad_vec_and_octahedral():
    u = np.array([1.0, 2.0, 3.0])
    v = np.array([0.5, -1.0, 2.0])
    for mandel in ("SYMMETRIC", "GENERAL"):
        got = pt.vec_dyad_vec(2.0, u, v, pt.Mandel[mandel], device=CPU)
        _tclose(got.vec, jt.vec_dyad_vec(2.0, u, v, jt.Mandel[mandel]).vec)
    _tclose(pt.vec_dyad_vec(2.0, u, v, device=CPU).as_matrix(),
            2.0 * 0.5 * (np.outer(u, v) + np.outer(v, u)))
    for two_dim in (False, True):
        t = pt.Tensor2.from_octahedral(2.0, 1.5, 0.3, two_dim, CPU)
        _tclose(t.vec, jt.Tensor2.from_octahedral(2.0, 1.5, 0.3, two_dim).vec)
        assert t.octahedral_distance().item() == pytest.approx(2.0, abs=1e-12)
        assert t.octahedral_radius().item() == pytest.approx(1.5, abs=1e-12)
        assert t.invariant_lode().item() == pytest.approx(0.3, abs=1e-10)


# -------------------- torch.func.vmap against jax.vmap ----------------------

def _le(pkg, dev):
    return (pkg.LinElasticity(210e3, 0.3) if pkg is jt else
            pkg.LinElasticity(210e3, 0.3, device=dev))


def _spectral2d(pkg, x, dev):
    sp = (pkg.Spectral2(True) if pkg is jt else pkg.Spectral2(True, dev))
    sp.decompose(pkg.Tensor2(pkg.Mandel.SYMMETRIC_2D, x))
    mat = [p.vec for p in sp.projectors]
    return sp.lambdas, (jnp.stack(mat) if pkg is jt else torch.stack(mat))


# name -> (Mandel of the input, fn(package, x) returning arrays)
VMAPPED = {
    "calc_stress": ("SYMMETRIC", lambda k, x: _le(k, x.device if k is pt
                                                  else None).calc_stress(
        k.Tensor2(k.Mandel.SYMMETRIC, x)).vec),
    "invariant_ii3": ("SYMMETRIC", lambda k, x: k.Tensor2(
        k.Mandel.SYMMETRIC, x).invariant_ii3()),
    "invariant_lode": ("SYMMETRIC", lambda k, x: k.Tensor2(
        k.Mandel.SYMMETRIC, x).invariant_lode()),
    "inverse": ("SYMMETRIC", lambda k, x: k.Tensor2(
        k.Mandel.SYMMETRIC, x).inverse().vec),
    "squared_general": ("GENERAL", lambda k, x: k.Tensor2(
        k.Mandel.GENERAL, x).squared().vec),
    "t2_qsd_t2": ("SYMMETRIC", lambda k, x: k.t2_qsd_t2(
        0.5, k.Tensor2(k.Mandel.SYMMETRIC, x),
        k.Tensor2(k.Mandel.SYMMETRIC, x).deviator()).mat),
    "deriv1_invariant_lode": ("SYMMETRIC", lambda k, x:
                              k.deriv1_invariant_lode(
                                  k.Tensor2(k.Mandel.SYMMETRIC, x)).vec),
    "deriv2_invariant_jj3": ("SYMMETRIC", lambda k, x: k.deriv2_invariant_jj3(
        k.Tensor2(k.Mandel.SYMMETRIC, x)).mat),
    "deriv_inverse_tensor": ("SYMMETRIC", lambda k, x: k.deriv_inverse_tensor(
        k.Tensor2(k.Mandel.SYMMETRIC, x)).mat),
    "spectral2_2d": ("SYMMETRIC_2D", lambda k, x: _spectral2d(
        k, x, x.device if k is pt else None)),
}


@pytest.mark.parametrize("name", sorted(VMAPPED))
def test_vmap_batches_as_the_reference(name):
    mandel, fn = VMAPPED[name]
    x = np.random.default_rng(31).standard_normal((8, jt.Mandel[mandel].dim()))
    want = jax.vmap(lambda v: fn(jt, v))(jnp.asarray(x))
    got = torch.func.vmap(lambda v: fn(pt, v))(torch.as_tensor(x))
    one = [fn(pt, torch.as_tensor(x[i])) for i in range(8)]
    if name == "spectral2_2d":
        for i in range(8):
            _tclose(got[0][i], one[i][0])
            lam = np.asarray(want[0][i])
            _tclose(got[0][i], lam)
            norm = float(np.max(np.abs(x[i])))
            for j in range(3):
                if min(abs(lam[j] - lam[k]) for k in range(3)
                       if k != j) > 1e-6 * norm:
                    _tclose(got[1][i][j], np.asarray(want[1][i][j]),
                            rtol=1e-12)
                    _tclose(got[1][i][j], one[i][1][j], rtol=1e-12)
        return
    for i in range(8):
        _tclose(got[i], one[i])
        _tclose(got[i], np.asarray(want[i]))


def test_spectral2_3d_does_not_batch_in_either_package():
    x = np.random.default_rng(37).standard_normal((8, 6))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.vmap(lambda v: jt.Spectral2().decompose(
            jt.Tensor2(jt.Mandel.SYMMETRIC, v)).lambdas)(jnp.asarray(x))
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda v: pt.Spectral2(device=v.device).decompose(
            pt.Tensor2(pt.Mandel.SYMMETRIC, v)).lambdas)(torch.as_tensor(x))
