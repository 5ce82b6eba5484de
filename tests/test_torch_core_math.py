"""core/ and math/ of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_core.py`` and ``tests/test_math.py`` are the checklists (the
Chebyshev cases are in ``tests/test_torch_pde.py``). The same seeded numpy
inputs go through both packages; the port computes on ``device="cpu"``.

Tolerances:
- the host modules (check, formatters, sort, peaks, read_table, the
  Legendre point and weight sets) are copies: equal results;
- ``linspace``/``generate*``: bit for bit against the reference's formula
  ``start (1 - t) + stop t``, t = i/(n - 1), evaluated in numpy, and
  against the reference's values on test_core.py's cases; elsewhere
  within 2 ulp of max(|start|, |stop|) of the reference, whose compiled
  ``jnp.linspace`` multiplies by the reciprocal of n - 1 and contracts
  multiply-adds on the CPU (its HLO), so its bits vary with n;
- special functions computing the same formula in both packages (Bessel
  J/Y/K by Clenshaw, the Carlson duplications, Legendre, composition):
  |port - reference| <= 1e-13 max(|reference|, 1), the transcendental
  functions (sin, cos, log, exp, sqrt) being libm's here and XLA's there;
- library routines that differ: ``torch.lgamma`` against XLA's lgamma
  (gamma, ln_gamma, beta, ln_beta) 1e-13 relative; ``torch.special``'s
  erf/erfc against XLA's 1e-14 absolute (test_math.py's bound);
  ``torch.special.erfinv`` against XLA's erfinv 1e-9 relative (the
  reference's own bound against scipy) and against scipy 1e-14;
  ``torch.special.i0/i1`` (I0, I1, In, and the small branches of K0, K1,
  Kn) against XLA's 1e-13 relative.
"""

import ast
import importlib
import math
import os

import numpy as np
import pytest
import torch
from scipy import special as sp

import russell_tpu
import russell_tpu.core as jcore
import russell_tpu.math as jm
import russell_tpu_torch
import russell_tpu_torch.core as pcore
import russell_tpu_torch.math as pm
from russell_tpu.core.enums import mat_norm as j_mat_norm
from russell_tpu.core.enums import vec_norm as j_vec_norm
from russell_tpu_torch.core.enums import mat_norm, vec_norm

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_formula(got, want, tol=1e-13):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(np.isnan(want), np.isnan(got))
    assert np.array_equal(got[~fin & ~np.isnan(want)],
                          want[~fin & ~np.isnan(want)])
    err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)
    assert err.size == 0 or err.max() <= tol, err.max()


def _rel(got, want, tol):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


# -- public names --------------------------------------------------------------


def _init_names(path):
    """Names an ``__init__.py`` binds: its imports and top-level defs."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", ["", "core", "math", "dense", "algo"])
def test_port_exports_every_public_name(sub):
    """Each name of russell_tpu's core, math, dense and algo __init__s and
    of its top-level re-exports exists in the port."""
    ref = os.path.join(ROOT, "russell_tpu", sub, "__init__.py")
    names = _init_names(ref)
    if not sub:
        # the top level's re-exports of core (russell_tpu/__init__.py)
        names = {n for n in names if not n.startswith("__")} | {"core"}
    mod = importlib.import_module(
        "russell_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names if not hasattr(mod, n))
    assert not missing, missing
    assert names


# -- core ----------------------------------------------------------------------


def test_check_assertions():
    for mod in (jcore, pcore):
        mod.approx_eq(3.0000001, 3.0, 1e-6)
        with pytest.raises(AssertionError):
            mod.approx_eq(1.0, 2.0, 1e-6)
        with pytest.raises(AssertionError, match="NaN"):
            mod.approx_eq(np.nan, 2.0, 1e-6)
        with pytest.raises(AssertionError, match="Inf"):
            mod.approx_eq(np.inf, 2.0, 1e-6)
        mod.array_approx_eq([1.0, 2.0], [1.0, 2.0 + 1e-12], 1e-10)
        with pytest.raises(AssertionError, match="shapes"):
            mod.array_approx_eq([1.0], [1.0, 2.0], 1e-6)
        mod.complex_approx_eq(1 + 2j, 1 + 2j + 1e-14, 1e-10)
        with pytest.raises(AssertionError):
            mod.complex_approx_eq(1 + 2j, 1 + 3j, 1e-6)
        mod.assert_alike(np.nan, np.nan)
        mod.assert_alike(1.0, 1.0 + 1e-16)
        with pytest.raises(AssertionError):
            mod.assert_alike(1.0, 2.0)
        mod.deriv1_approx_eq(np.cos(0.7), 0.7, 1e-9, np.sin)
        mod.deriv2_approx_eq(-np.sin(0.7), 0.7, 1e-8, np.sin)
        with pytest.raises(AssertionError):
            mod.deriv1_approx_eq(1.5, 0.7, 1e-9, np.sin)
    # the port's helpers take tensors (brought to the host), complex too
    pcore.array_approx_eq(torch.tensor([1.0, 2.0]), [1.0, 2.0], 1e-15)
    pcore.complex_array_approx_eq(torch.tensor([1 + 2j]), [1 + 2j], 1e-15)
    pcore.approx_eq(torch.tensor(2.0), 2.0, 0.0)
    for name in ("deriv1_central5", "deriv1_forward4", "deriv1_backward4",
                 "deriv2_central5"):
        assert getattr(pcore, name)(0.3, math.exp) == \
            getattr(jcore, name)(0.3, math.exp)


def test_norms_match_reference():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(17)
    m = rng.standard_normal((5, 7))
    Norm, JNorm = pcore.Norm, jcore.Norm
    for k in ("ONE", "EUC", "FRO", "INF", "MAX"):
        _rel(vec_norm(v, Norm[k], device=CPU), j_vec_norm(v, JNorm[k]), 1e-15)
        assert float(vec_norm(np.zeros(0), Norm[k], device=CPU)) == 0.0
    for k in ("ONE", "INF", "FRO", "MAX"):
        _rel(mat_norm(m, Norm[k], device=CPU), j_mat_norm(m, JNorm[k]),
             1e-15)
    vt = torch.as_tensor(v)
    assert vec_norm(vt, Norm.MAX).device == vt.device
    assert float(vec_norm([-3.0, 4.0], Norm.ONE, device=CPU)) == 7.0
    assert float(mat_norm([[1.0, -2.0], [3.0, 4.0]], Norm.INF,
                          device=CPU)) == 7.0


def test_formatters_sort_peaks_stopwatch():
    for x in (3723000.0, -1.5, 0.0, 1e-300, math.inf, 123.456):
        assert pcore.format_fortran(x) == jcore.format_fortran(x)
        assert pcore.format_scientific(x, 10, 2) == \
            jcore.format_scientific(x, 10, 2)
    for ns in (0, 800, 123_450_000, 62_300_000_000, 9_000_000_000_000):
        assert pcore.format_nanoseconds(ns) == jcore.format_nanoseconds(ns)
    from russell_tpu.core.formatters import vec_fmt_scientific as jfmt
    from russell_tpu_torch.core.formatters import vec_fmt_scientific as pfmt
    assert pfmt(torch.tensor([1.0, -2.5])) == jfmt(np.array([1.0, -2.5]))
    rng = np.random.default_rng(2)
    y = rng.standard_normal(40)
    assert pcore.find_valleys_and_peaks(torch.as_tensor(y)) == \
        jcore.find_valleys_and_peaks(y)
    assert pcore.find_valleys_and_peaks([0, 2, 1, 3, 0.5]) == ([2], [1, 3])
    from russell_tpu.core import sort as jsort
    from russell_tpu_torch.core import sort as psort
    for args in ((2, 1), (3, 1, 2), (4, 3, 2, 1)):
        k = len(args)
        assert getattr(psort, f"sort{k}")(*args) == \
            getattr(jsort, f"sort{k}")(*args)
        assert getattr(psort, f"argsort{k}")(*args) == \
            getattr(jsort, f"argsort{k}")(*args)
    sw = pcore.Stopwatch()
    assert sw.stop() >= 0
    sw.reset()
    assert sw.elapsed() == 0


def test_read_table_and_data(tmp_path):
    path = tmp_path / "table.txt"
    path.write_text("# comment\nx  y  z\n1 2 3\n\n4.5 5 -6e-3\n")
    got, want = pcore.read_table(str(path)), jcore.read_table(str(path))
    assert list(got) == list(want)
    for k in got:
        assert np.array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        pcore.read_table(str(path), labels=["x", "y"])
    data = tmp_path / "data.txt"
    data.write_text("1 2\n3 4\n")
    assert np.array_equal(pcore.read_data(str(data)),
                          jcore.read_data(str(data)))


def test_linspace_and_generators():
    # test_core.py's cases: the reference's values, bit for bit
    cases = [(0.0, 1.0, 5), (0, 1, 0), (3.0, 9.0, 1), (0.0, 1.0, 2)]
    for a, b, n in cases:
        got = pcore.linspace(a, b, n, device=CPU)
        want = np.asarray(jcore.linspace(a, b, n))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    X, Y = pcore.generate2d(0, 1, 0, 2, 3, 2, device=CPU)
    JX, JY = jcore.generate2d(0, 1, 0, 2, 3, 2)
    assert np.array_equal(X.numpy(), JX) and np.array_equal(Y.numpy(), JY)
    G = pcore.generate3d(0, 1, 0, 1, 0, 1, 2, 3, 4, device=CPU)
    JG = jcore.generate3d(0, 1, 0, 1, 0, 1, 2, 3, 4)
    for g, jg in zip(G, JG):
        assert g.shape == (4, 3, 2) and np.array_equal(g.numpy(), jg)
    # seeded cases: the formula's bits, and the reference within 2 ulp
    rng = np.random.default_rng(3)
    for _ in range(6):
        a, b = rng.uniform(-10, 10, 2)
        n = int(rng.integers(2, 300))
        t = np.arange(n - 1) / (n - 1)
        formula = np.concatenate([a * (1.0 - t) + b * t, [b]])
        got = pcore.linspace(a, b, n, device=CPU).numpy()
        assert np.array_equal(got, formula)
        want = np.asarray(jcore.linspace(a, b, n))
        ulp = np.spacing(max(abs(a), abs(b)))
        assert np.abs(got - want).max() <= 2 * ulp
    t = torch.tensor([1.0 + 2.0j, 3.0 - 1.0j])
    assert np.array_equal(pcore.fetch_host(t), jcore.fetch_host(t.numpy()))


# -- math ----------------------------------------------------------------------

# one length for every input below: the reference compiles each of its
# eager operations once per shape
N = 128


def _pts(*edges, lo=0.0, hi=1.0, seed=0):
    """N points: ``edges`` then seeded uniform draws in [lo, hi)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([edges, rng.uniform(lo, hi, N - len(edges))])


XS = _pts(1e-6, 0.5, 7.9, 8.0, 8.1, 16.9, 17.0, 17.1, 25.9, 26.0, 26.1, 30.0,
          200.0, lo=1e-6, hi=60.0, seed=1)


def test_bessel_j_y():
    xs = _pts(0.0, -1.0, -3.0, *XS[:13], lo=1e-6, hi=60.0, seed=1)
    for name in ("bessel_j0", "bessel_j1", "bessel_y0", "bessel_y1"):
        _same_formula(getattr(pm, name)(xs, device=CPU),
                      getattr(jm, name)(xs))
    for n in (5, 20):
        _same_formula(pm.bessel_jn(n, XS, device=CPU), jm.bessel_jn(n, XS))
        _same_formula(pm.bessel_yn(n, XS, device=CPU), jm.bessel_yn(n, XS))
    # negative order: J_{-n} = (-1)^n J_n, Y_{-n} = (-1)^n Y_n
    assert float(pm.bessel_jn(-3, 2.5, device=CPU)) == pytest.approx(
        -sp.jn(3, 2.5), abs=1e-15)
    assert float(pm.bessel_yn(-3, 2.5, device=CPU)) == \
        -float(pm.bessel_yn(3, 2.5, device=CPU))
    # against scipy at test_math.py's bounds
    w = sp.jn(5, XS)
    got = pm.bessel_jn(5, torch.as_tensor(XS)).numpy()
    assert np.max(np.abs(got - w) / np.maximum(np.abs(w), 1.0)) < 1e-14
    assert np.max(np.abs(pm.bessel_y0(XS, device=CPU).numpy()
                         - sp.y0(XS))) < 2e-14
    assert float(pm.bessel_y0(0.0, device=CPU)) == -math.inf
    assert math.isnan(float(pm.bessel_y1(-1.0, device=CPU)))


def test_bessel_modified():
    xs = _pts(0.0, 30.0, lo=1e-3, hi=30.0, seed=2)
    for name in ("bessel_i0", "bessel_i1"):
        _rel(getattr(pm, name)(xs, device=CPU), getattr(jm, name)(xs), 1e-13)
    _rel(pm.bessel_in(5, xs[1:], device=CPU), jm.bessel_in(5, xs[1:]), 1e-13)
    _rel(pm.bessel_in(-2, xs[1:], device=CPU), sp.iv(2, xs[1:]), 1e-13)
    assert float(pm.bessel_in(3, 0.0, device=CPU)) == 0.0
    xk = _pts(1e-5, 2.0, 60.0, lo=1e-5, hi=60.0, seed=3)
    for name in ("bessel_k0", "bessel_k1"):
        _rel(getattr(pm, name)(xk, device=CPU), getattr(jm, name)(xk), 1e-13)
    for n in (2, 10):
        _rel(pm.bessel_kn(n, xk, device=CPU), jm.bessel_kn(n, xk), 1e-13)
        assert np.max(np.abs(pm.bessel_kn(n, xk, device=CPU).numpy()
                             - sp.kn(n, xk)) / sp.kn(n, xk)) < 1e-13
    assert float(pm.bessel_k0(0.0, device=CPU)) == math.inf
    assert math.isnan(float(pm.bessel_k1(-1.0, device=CPU)))


def test_gamma_beta_family():
    xs = _pts(0.5, 1.0, 1.5, 3.7, 10.0, 20.5, -0.5, -2.5, -0.0, 0.0, -2.0,
              -7.0, lo=-12.0, hi=40.0, seed=4)
    g, jg = pm.gamma(xs, device=CPU).numpy(), np.asarray(jm.gamma(xs))
    assert np.array_equal(np.isnan(g), np.isnan(jg))
    assert np.array_equal(np.isinf(g), np.isinf(jg))
    ok = np.isfinite(jg)
    _rel(g[ok], jg[ok], 1e-13)
    _rel(pm.ln_gamma(xs, device=CPU)[ok], np.asarray(jm.ln_gamma(xs))[ok],
         1e-13)
    np.testing.assert_allclose(pm.gamma(xs[:6], device=CPU).numpy(),
                               sp.gamma(xs[:6]), rtol=1e-13)
    # beta and ln_beta, including b >= 8 (algdiv) and large arguments,
    # where lgamma(a) + lgamma(b) - lgamma(a + b) would lose digits
    a = _pts(2.0, 0.5, 3.0, 1e6, lo=0.1, hi=30.0, seed=5)
    b = _pts(3.0, 9.0, 1e7, 2e6, lo=0.1, hi=30.0, seed=6)
    _rel(pm.ln_beta(a, b, device=CPU), jm.ln_beta(a, b), 1e-13)
    _rel(pm.beta(a, b, device=CPU), jm.beta(a, b), 1e-13)
    # scipy agrees below b = 8 only: the reference's algdiv (jax's copy of
    # cdflib's) takes x = h/(1+h) where cdflib has 1/(1+h), 7e-7 off at
    # b >= 8; the port keeps the reference's bits
    small = np.maximum(a, b) < 8
    _rel(pm.ln_beta(a[small], b[small], device=CPU),
         sp.betaln(a[small], b[small]), 1e-13)
    assert float(pm.beta(2.0, 3.0, device=CPU)) == pytest.approx(1 / 12,
                                                                 rel=1e-13)
    assert pm.factorial_lookup_22(5) == jm.factorial_lookup_22(5) == 120.0
    with pytest.raises(ValueError):
        pm.factorial_lookup_22(23)


def test_erf_family():
    xs = _pts(-3.0, 0.0, 3.0, lo=-3.0, hi=3.0, seed=7)
    np.testing.assert_allclose(pm.erf(xs, device=CPU).numpy(),
                               np.asarray(jm.erf(xs)), rtol=0, atol=1e-14)
    np.testing.assert_allclose(pm.erfc(xs, device=CPU).numpy(),
                               np.asarray(jm.erfc(xs)), rtol=0, atol=1e-14)
    ys = _pts(-0.99, 0.0, 0.99, lo=-0.99, hi=0.99, seed=8)
    _rel(pm.erf_inv(ys, device=CPU), jm.erf_inv(ys), 1e-9)
    _rel(pm.erf_inv(ys, device=CPU), sp.erfinv(ys), 1e-14)
    _rel(pm.erfc_inv(1.0 - ys, device=CPU), jm.erfc_inv(1.0 - ys), 1e-9)
    edge = _pts(1.0, -1.0, 1.5, -2.0, lo=-0.5, hi=0.5, seed=9)
    got, want = pm.erf_inv(edge, device=CPU).numpy(), np.asarray(
        jm.erf_inv(edge))
    assert np.array_equal(got[:2], want[:2]) and np.isnan(got[2:4]).all()


def test_elliptic():
    phi = _pts(0.0, 0.1, 0.7, 1.2, np.pi / 2, np.pi / 2, -0.1, lo=0.0,
               hi=np.pi / 2, seed=10)
    m = _pts(0.0, 0.5, 0.9, 1.0, 0.5, 1.0, 0.5, lo=0.0, hi=1.0, seed=11)
    n = _pts(0.3, -0.5, 0.8, 0.0, 0.5, 0.2, 0.1, lo=-1.0, hi=0.9, seed=12)
    _same_formula(pm.elliptic_f(phi, m, device=CPU), jm.elliptic_f(phi, m))
    _same_formula(pm.elliptic_e(phi, m, device=CPU), jm.elliptic_e(phi, m))
    _same_formula(pm.elliptic_pi(n, phi, m, device=CPU),
                  jm.elliptic_pi(n, phi, m))
    ok = (m * np.sin(phi) ** 2 < 1) & (phi >= 0)
    np.testing.assert_allclose(pm.elliptic_f(phi, m, device=CPU).numpy()[ok],
                               sp.ellipkinc(phi, m)[ok], rtol=1e-13)
    ok = phi >= 0
    np.testing.assert_allclose(pm.elliptic_e(phi, m, device=CPU).numpy()[ok],
                               sp.ellipeinc(phi, m)[ok], rtol=1e-13)
    # out of the domain -> NaN; m sin^2 = 1 -> inf
    assert math.isnan(float(pm.elliptic_f(phi, m, device=CPU)[6]))
    assert float(pm.elliptic_f(phi, m, device=CPU)[5]) == math.inf
    x, y, z, p = (_pts(lo=0.1, hi=3.0, seed=s) for s in (13, 14, 15, 16))
    for name, args in (("carlson_rf", (x, y, z)), ("carlson_rd", (x, y, z)),
                       ("carlson_rj", (x, y, z, p)), ("carlson_rc", (x, y))):
        _same_formula(getattr(pm, name)(*args, device=CPU),
                      getattr(jm, name)(*args))
    np.testing.assert_allclose(pm.carlson_rj(x, y, z, p, device=CPU).numpy(),
                               sp.elliprj(x, y, z, p), rtol=1e-13)


def test_legendre():
    xs = _pts(-1.0, 0.0, 1.0, lo=-1.0, hi=1.0, seed=17)
    for n in (0, 1, 2, 5, 10):
        for name in ("legendre_pn", "legendre_pn_deriv1",
                     "legendre_pn_deriv2"):
            _same_formula(getattr(pm, name)(n, xs, device=CPU),
                          getattr(jm, name)(n, xs))
    for nn in (1, 4, 9):
        for name in ("legendre_gauss_points", "legendre_gauss_weights",
                     "legendre_lobatto_points", "legendre_lobatto_weights"):
            assert np.array_equal(getattr(pm, name)(nn),
                                  getattr(jm, name)(nn))
    xn, wn = np.polynomial.legendre.leggauss(5)
    np.testing.assert_allclose(pm.legendre_gauss_points(4), xn, atol=1e-13)
    np.testing.assert_allclose(pm.legendre_gauss_weights(4), wn, atol=1e-13)


def test_composition_and_helpers():
    xs = _pts(0.0, -0.0, 1.0, -1.0, -500.0, lo=-5.0, hi=5.0, seed=18)
    for name in ("sign", "ramp", "heaviside", "logistic",
                 "logistic_deriv1"):
        _same_formula(getattr(pm, name)(xs, device=CPU),
                      getattr(jm, name)(xs), 1e-15)
    for name in ("smooth_ramp", "smooth_ramp_deriv1", "smooth_ramp_deriv2"):
        _same_formula(getattr(pm, name)(xs, 2.0, device=CPU),
                      getattr(jm, name)(xs, 2.0))
    for name in ("suq_sin", "suq_cos"):
        _same_formula(getattr(pm, name)(xs, 2.5, device=CPU),
                      getattr(jm, name)(xs, 2.5))
    _same_formula(pm.boxcar(xs, -1.0, 2.0, device=CPU),
                  jm.boxcar(xs, -1.0, 2.0), 0.0)
    _same_formula(pm.modulo(xs, 1.5, device=CPU), jm.modulo(xs, 1.5), 0.0)
    assert float(pm.modulo(-5.5, 2.0, device=CPU)) == -1.5
    for n in (0, 3, -4):
        assert float(pm.neg_one_pow_n(n, device=CPU)) == \
            float(jm.neg_one_pow_n(n))
    for fn, args in (("float_is_integer", (4.0,)),
                     ("float_is_neg_integer", (-3.0,)),
                     ("float_split", (3.25,)), ("float_decompose", (8.0,)),
                     ("float_compose", (0.5, 4)), ("i_pow_n", (2,)),
                     ("x_times_i_pow_n", (3.0, 3))):
        assert getattr(pm, fn)(*args) == getattr(jm, fn)(*args)
    for name in ("PI", "EULER", "SQRT_EPSILON", "GOLDEN_RATIO", "LN10"):
        assert getattr(pm, name) == getattr(jm, name)


def test_batched_and_autograd():
    """test_math.py's jit/vmap/grad case: the port evaluates a batch at
    once, and autograd flows through bessel_j0 (dJ0/dx = -J1)."""
    xs = torch.linspace(0, 50, 64, dtype=torch.float64).reshape(8, 8)
    np.testing.assert_allclose(pm.bessel_j0(xs).numpy(),
                               sp.j0(xs.numpy()), atol=1e-14)
    x = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    (d,) = torch.autograd.grad(pm.bessel_j0(x), x)
    assert float(d) == pytest.approx(-sp.j1(1.5), abs=1e-6)
    g = pm.elliptic_e(torch.tensor(1.0, dtype=torch.float64), 0.5)
    assert float(g) == pytest.approx(sp.ellipeinc(1.0, 0.5), rel=1e-12)


def test_top_level_reexports():
    for name in ("approx_eq", "Norm", "Stopwatch", "linspace",
                 "format_fortran"):
        assert getattr(russell_tpu_torch, name) is getattr(pcore, name)
        assert hasattr(russell_tpu, name)
