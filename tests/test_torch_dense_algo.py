"""dense/ and algo/ of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_dense.py`` and ``tests/test_algo.py`` are the checklists (the
Lagrange interpolant and ``misc`` are held in ``tests/test_torch_pde.py``).
The same seeded numpy inputs go through both packages; the port computes
on ``device="cpu"``.

Tolerances:
- elementwise and BLAS-like results: 1e-14 relative to the largest entry
  (the libraries sum in other orders);
- decompositions (Cholesky, eigen, SVD, inverse, pseudo-inverse): by
  their invariants at 1e-12 (L L^T = A, A V = V diag(w), U S V^T = A,
  A A^+ A = A), eigenvalues against the reference's at 1e-12; vector
  signs and phases differ between LAPACK builds, so no vector is
  compared entry by entry;
- ``mat_eigen_sym_jacobi``'s plain version against the reference at
  n 2, 6 and 17: 1e-12 (the reference's jitted scan may contract
  multiply-adds on the CPU); the CUDA kernel's update order, walked in
  numpy, equals the plain version bit for bit;
- the algorithms' Stats counters: equal; their results at 1e-12 or as
  stated.
"""

import math

import numpy as np
import pytest
import torch

import russell_tpu.algo as JA
import russell_tpu.dense as JD
import russell_tpu_torch.algo as PA
import russell_tpu_torch.dense as PD
from russell_tpu_torch.dense import matrix_ops

CPU = "cpu"


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


def _close(got, want, tol=1e-14):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    assert np.abs(got - want).max() <= tol * scale


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


# -- dense ---------------------------------------------------------------------


def test_vector_ops():
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(9), rng.standard_normal(9)
    for name, args in (("vec_add", (2.0, u, -1.0, v)), ("vec_inner", (u, v)),
                       ("vec_rms_scaled", (u, v, 1.0, 0.1)),
                       ("vec_max_scaled", (u, v)),
                       ("vec_max_abs_diff", (u, v)), ("vec_scale", (3.0, u)),
                       ("vec_update", (0.5, u, v)), ("vec_copy", (u,)),
                       ("vec_norm", (u,))):
        _close(getattr(PD, name)(*args, device=CPU),
               getattr(JD, name)(*args))
    z = u + 1j * v
    _close(PD.vec_inner(z, z[::-1].copy(), device=CPU),
           JD.vec_inner(z, z[::-1].copy()))
    assert bool(PD.vec_all_finite(u, device=CPU))
    assert not bool(PD.vec_all_finite([1.0, np.nan], device=CPU))
    zz = PD.complex_vec_zip(u, v, device=CPU)
    assert np.array_equal(zz.numpy(), np.asarray(JD.complex_vec_zip(u, v)))
    r, i = PD.complex_vec_unzip(zz)
    assert np.array_equal(r.numpy(), u) and np.array_equal(i.numpy(), v)
    assert PD.vec_fmt_scientific(u[:3]) == JD.vec_fmt_scientific(u[:3])
    ut = torch.as_tensor(u)
    assert PD.vec_add(1.0, ut, 1.0, ut).device == ut.device


def test_matvec_ops():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 4))
    u, w = rng.standard_normal(4), rng.standard_normal(5)
    for name, args in (("mat_vec_mul", (2.0, a, u)),
                       ("mat_vec_mul_update", (2.0, a, u, -0.5, w)),
                       ("vec_mat_mul", (1.5, w, a)),
                       ("vec_outer", (2.0, w, u)),
                       ("vec_outer_update", (2.0, w, u, a)),
                       ("mat_sum_rows", (a,)), ("mat_sum_cols", (a,))):
        _close(getattr(PD, name)(*args, device=CPU),
               getattr(JD, name)(*args))


def test_solve_lin_sys():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 6)) + 4 * np.eye(6)
    b = rng.standard_normal(6)
    x = PD.solve_lin_sys(a, b, device=CPU).numpy()
    _close(a @ x, b, 1e-13)
    _close(x, JD.solve_lin_sys(a, b), 1e-13)
    ac = a + 1j * rng.standard_normal((6, 6))
    bc = b + 1j
    xc = PD.solve_lin_sys(ac, bc, device=CPU).numpy()
    assert np.abs(ac @ xc - bc).max() < 1e-12
    with pytest.raises(ValueError):
        PD.solve_lin_sys(np.ones((2, 3)), b[:2], device=CPU)
    with pytest.raises(ValueError):
        PD.solve_lin_sys(np.eye(2), b, device=CPU)


def test_matrix_basic():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((4, 4)), rng.standard_normal((4, 4))
    c = rng.standard_normal((4, 4))
    for name, args in (("mat_add", (1.0, a, 10.0, b)),
                       ("mat_mat_mul", (2.0, a, b)),
                       ("mat_t_mat_mul", (2.0, a, b)),
                       ("mat_sym_rank_op", (2.0, a, 0.5, c)),
                       ("mat_copy", (a,)), ("mat_scale", (3.0, a)),
                       ("mat_update", (0.5, a, b)),
                       ("mat_max_abs_diff", (a, b))):
        _close(getattr(PD, name)(*args, device=CPU),
               getattr(JD, name)(*args))
    _close(PD.mat_sym_rank_op(2.0, a, 0.5, c, transposed=True, device=CPU),
           JD.mat_sym_rank_op(2.0, a, 0.5, c, transposed=True))
    from russell_tpu.core import Norm as JNorm
    from russell_tpu_torch.core import Norm
    _close(PD.mat_norm(a, Norm.ONE, device=CPU), JD.mat_norm(a, JNorm.ONE))


def test_cholesky():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((7, 7))
    a = g @ g.T + 7 * np.eye(7)
    low = PD.mat_cholesky(a, device=CPU).numpy()
    _close(low @ low.T, a, 1e-12)
    up = PD.mat_cholesky(a, lower=False, device=CPU).numpy()
    _close(up.T @ up, a, 1e-12)
    _close(low, JD.mat_cholesky(a), 1e-12)


def _eig_residual(a, planes):
    lr, li, vr, vi = (_np(p) for p in planes)
    lam, V = lr + 1j * li, vr + 1j * vi
    return np.abs(a @ V - V * lam[..., None, :]).max()


def test_eigen_general():
    a = np.array([[0.0, 1.0], [-2.0, -3.0]])  # eigenvalues -1, -2
    planes = PD.mat_eigen(a, device=CPU)
    assert _eig_residual(a, planes) < 1e-12
    _close(np.sort(planes[0].numpy()), [-2.0, -1.0], 1e-12)
    rot = np.array([[0.0, -1.0], [1.0, 0.0]])
    w = np.sort_complex(PD.mat_eigenvalues(rot, device=CPU).numpy())
    np.testing.assert_allclose(w, [-1j, 1j], atol=1e-12)
    # batched, as test_dense.py vmaps it; a random 6x6 against the
    # reference's eigenvalues
    rng = np.random.default_rng(6)
    g = rng.standard_normal((6, 6))
    batch = np.stack([a, a.T, rot])
    bp = PD.mat_eigen(torch.as_tensor(batch))
    assert all(p.shape[0] == 3 for p in bp)
    assert _eig_residual(batch, bp) < 1e-12
    gp = PD.mat_eigen(g, device=CPU)
    assert _eig_residual(g, gp) < 1e-12
    jl = JD.mat_eigenvalues(g)
    np.testing.assert_allclose(np.sort_complex(gp[0].numpy()
                                               + 1j * gp[1].numpy()),
                               np.sort_complex(np.asarray(jl)), atol=1e-12)
    # generalized: B^-1 A
    ga, gb = np.diag([2.0, 3.0]), np.diag([1.0, 2.0])
    lr, _, _, _ = PD.mat_gen_eigen(ga, gb, device=CPU)
    _close(np.sort(lr.numpy()), [1.5, 2.0], 1e-12)


def test_eigen_sym_and_herm():
    a = _sym(8, 7)
    w, v = (t.numpy() for t in PD.mat_eigen_sym(a, device=CPU))
    _close(v @ np.diag(w) @ v.T, a, 1e-12)
    _close(w, JD.mat_eigen_sym(a)[0], 1e-12)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
    h = (h + h.conj().T) / 2
    wh, vh = (t.numpy() for t in PD.mat_eigen_herm(h, device=CPU))
    assert np.abs(vh @ np.diag(wh) @ vh.conj().T - h).max() < 1e-12
    _close(wh, JD.mat_eigen_herm(h)[0], 1e-12)


@pytest.mark.parametrize("n", [2, 6, 17])
def test_jacobi_plain_version_matches_reference(n):
    a = np.array([[2.0, 1.0], [1.0, 2.0]]) if n == 2 else _sym(n, n)
    w, V = PD.mat_eigen_sym_jacobi(torch.as_tensor(a))
    jw, jV = (np.asarray(t) for t in JD.mat_eigen_sym_jacobi(a))
    _close(w, jw, 1e-12)
    _close(V.numpy() @ np.diag(w.numpy()) @ V.numpy().T, a, 1e-12)
    _close(np.abs(V.numpy()), np.abs(jV), 1e-12)
    if n == 2:
        _close(w, [1.0, 3.0], 1e-15)


def _kernel_walk(a, sweeps):
    """jacobi_eig.cu's update order in numpy: per rotation, c and s from
    the same scalar operations, then for every j outside {p, q} rows p, q
    at column j and columns p, q at row j from the entries before the
    rotation, the 2 x 2 block by the row stage then the column stage, and
    V^T's rows p, q."""
    n = a.shape[0]
    A, VT = a.copy(), np.eye(n)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                c, s = matrix_ops._rotation(float(A[p, q]), float(A[p, p]),
                                            float(A[q, q]))
                j = np.array([k for k in range(n) if k not in (p, q)], int)
                pp, pq, qp, qq = A[p, p], A[p, q], A[q, p], A[q, q]
                rpp, rpq = pp * c - qp * s, pq * c - qq * s
                rqp, rqq = pp * s + qp * c, pq * s + qq * c
                apj, aqj = A[p, j].copy(), A[q, j].copy()
                ajp, ajq = A[j, p].copy(), A[j, q].copy()
                A[p, j], A[q, j] = apj * c - aqj * s, apj * s + aqj * c
                A[j, p], A[j, q] = ajp * c - ajq * s, ajp * s + ajq * c
                A[p, p], A[p, q] = rpp * c - rpq * s, rpp * s + rpq * c
                A[q, p], A[q, q] = rqp * c - rqq * s, rqp * s + rqq * c
                vp, vq = VT[p].copy(), VT[q].copy()
                VT[p], VT[q] = vp * c - vq * s, vp * s + vq * c
    return np.diagonal(A).copy(), VT.T.copy()


@pytest.mark.parametrize("n", [2, 7])
def test_jacobi_kernel_order_equals_plain_version(n):
    a = np.array([[2.0, 1.0], [1.0, 2.0]]) if n == 2 else _sym(n, 3 * n)
    a[0, n - 1] = a[n - 1, 0] = 0.0  # a vanishing a_pq: t = 0
    w, V = matrix_ops._jacobi_eig_plain(torch.as_tensor(a), 30)
    kw, kV = _kernel_walk(a, 30)
    assert np.array_equal(w.numpy(), kw) and np.array_equal(V.numpy(), kV)
    assert float(PD.mat_eigen_sym_jacobi(a[:1, :1], device=CPU)[0][0]) == \
        a[0, 0]


def test_svd_inverse_pinv():
    a = np.array([[3.0, 1.0], [1.0, 3.0], [0.0, 2.0]])
    s, u, vt = (t.numpy() for t in PD.mat_svd(a, device=CPU))
    _close(u[:, :2] @ np.diag(s) @ vt, a, 1e-12)
    _close(s, JD.mat_svd(a)[0], 1e-12)
    for n in (1, 2, 3, 5):
        m = np.random.default_rng(n).standard_normal((n, n)) + 3 * np.eye(n)
        inv, det = PD.mat_inverse(m, device=CPU)
        jinv, jdet = JD.mat_inverse(m)
        _close(inv.numpy() @ m, np.eye(n), 1e-12)
        _close(inv, jinv, 1e-13)
        _close(det, jdet, 1e-13)
    p = PD.mat_pseudo_inverse(a, device=CPU).numpy()
    _close(a @ p @ a, a, 1e-12)
    _close(p, JD.mat_pseudo_inverse(a), 1e-12)
    # rank 1: the second singular value is dropped by both (rtol 1e-15)
    r1 = np.outer([1.0, 2.0, 3.0], [1.0, -1.0])
    _close(PD.mat_pseudo_inverse(r1, device=CPU), JD.mat_pseudo_inverse(r1),
           1e-12)


def test_band_and_exporters():
    a = np.array([
        [1.0, 2.0, 0.0, 0.0],
        [5.0, 1.0, 2.0, 0.0],
        [0.0, 5.0, 1.0, 2.0],
        [0.0, 0.0, 5.0, 1.0],
    ])
    for kl, ku in ((1, 1), (2, 0), (0, 3)):
        band = PD.mat_convert_to_blas_band(a, kl, ku, device=CPU)
        assert np.array_equal(band.numpy(),
                              np.asarray(JD.mat_convert_to_blas_band(a, kl,
                                                                     ku)))
    ta = torch.as_tensor(a)
    assert PD.mat_convert_to_blas_band(ta, 1, 1).device == ta.device
    assert PD.mat_to_numpy(ta[:2, :2]) == JD.mat_to_numpy(a[:2, :2])
    assert PD.mat_to_mathematica(ta) == JD.mat_to_mathematica(a)
    z = PD.complex_mat_zip(a, 2 * a, device=CPU)
    r, i = PD.complex_mat_unzip(z)
    assert np.array_equal(z.numpy(), np.asarray(JD.complex_mat_zip(a, 2 * a)))
    assert np.array_equal(r.numpy(), a) and np.array_equal(i.numpy(), 2 * a)


# -- algo ----------------------------------------------------------------------


def _counters(st):
    return (st.n_function, st.n_jacobian, st.n_iterations)


def test_interp_chebyshev():
    f = lambda x, a: math.cos(2.0 * x) + x * x  # noqa: E731
    got = PA.InterpChebyshev(30, -2.0, 3.0).adapt_function(1e-8, f)
    want = JA.InterpChebyshev(30, -2.0, 3.0).adapt_function(1e-8, f)
    assert got.get_degree() == want.get_degree()
    assert np.array_equal(got.get_coefficients(), want.get_coefficients())
    xs = np.random.default_rng(9).uniform(-2.5, 3.5, 64)
    _close(got.eval(xs, device=CPU), want.eval(xs), 1e-14)
    _close(got.eval_using_trig(torch.as_tensor(xs)), want.eval_using_trig(xs),
           1e-13)
    # test_algo.py's cases
    q = PA.InterpChebyshev(10, -4.0, 4.0)
    q.adapt_function(1e-8, lambda x, a: x * x - 1.0)
    jq = JA.InterpChebyshev(10, -4.0, 4.0)
    jq.adapt_function(1e-8, lambda x, a: x * x - 1.0)
    assert q.get_degree() == 2
    gx, gu = q.get_xy_data()
    wx, wu = jq.get_xy_data()
    assert np.array_equal(gx, wx) and np.array_equal(gu, wu)
    assert got.estimate_max_error(8, f) == pytest.approx(
        max(abs(f(x, None) - float(want.eval(x)))
            for x in np.linspace(-2.0, 3.0, 8)), abs=1e-15)
    assert float(q.eval(0.0, device=CPU)) == pytest.approx(-1.0, abs=1e-14)
    d = PA.InterpChebyshev(10, 0.0, 1.0).adapt_data(1e-8,
                                                    [-7.0, -4.5, 0.5, 3.0])
    jd = JA.InterpChebyshev(10, 0.0, 1.0).adapt_data(1e-8,
                                                     [-7.0, -4.5, 0.5, 3.0])
    assert d.get_degree() == jd.get_degree() == 1
    assert np.array_equal(d.get_coefficients(), jd.get_coefficients())
    zz = PA.InterpChebyshev.points(2)
    uu = ((4.0 - 4.0 + 8.0 * zz) / 2.0) ** 2 - 1.0
    s = PA.InterpChebyshev(2, -4.0, 4.0).set_data(uu)
    assert float(s.eval(0.0, device=CPU)) == pytest.approx(-1.0, abs=1e-14)
    c = PA.InterpChebyshev(4, 0.0, 1.0).set_function(0, lambda x, a: 2.5)
    assert float(c.eval([0.1, 0.2], device=CPU)) == 2.5


def test_root_finder():
    f = lambda x, a: x ** 4 - 1.0  # noqa: E731
    for mod in (PA, JA):
        interp = mod.InterpChebyshev(2, -2.0, 2.0).set_function(2, f)
        solver = mod.RootFinder().set_enable_stats(True)
        roots = solver.chebyshev(interp)
        solver.refine(roots, -2.0, 2.0, f)
        root = solver.brent(2.0, 4.0, lambda x, a: math.sin(x))
        if mod is PA:
            got = (roots, root, _counters(solver.get_stats()))
        else:
            want = (roots, root, _counters(solver.get_stats()))
    assert got == want
    np.testing.assert_allclose(got[0], [-1.0, 1.0], atol=1e-13)
    with pytest.raises(ValueError):
        PA.RootFinder().brent(0.0, 1.0, lambda x, a: x + 2.0)
    # a few functions of the corpus, roots equal to the reference's
    for tf, jtf in list(zip(PA.get_test_functions(),
                            JA.get_test_functions()))[:6]:
        if tf.root1 is None:
            continue
        rp = PA.RootFinder().chebyshev(PA.InterpChebyshev(
            100, tf.range_a, tf.range_b).adapt_function(1e-9, tf.f))
        rj = JA.RootFinder().chebyshev(JA.InterpChebyshev(
            100, jtf.range_a, jtf.range_b).adapt_function(1e-9, jtf.f))
        assert rp == rj, tf.name


def test_minimize_and_line_search():
    f = lambda x, a: (x - 2.0) ** 2 + 1.0 + 0.1 * math.sin(5 * x)  # noqa
    out = {}
    for mod in (PA, JA):
        br = mod.MinBracketing().set_enable_stats(True)
        b = br.basic(0.0, f)
        ms = mod.MinSolver().set_enable_stats(True)
        xmin = ms.brent(b.a, b.c, f)
        ls = mod.LineSearcher()
        t = ls.search(1.0, -1.0, 1.0, -2.0, lambda x, a: x * x)
        out[mod] = ((b.a, b.b, b.c, b.fa, b.fb, b.fc),
                    _counters(br.get_stats()), xmin,
                    _counters(ms.get_stats()), ms.stats.error_estimate, t,
                    _counters(ls.stats), mod.line_search(
                        1.0, -1.0, 1.0, -2.0, lambda x, a: x * x))
    assert out[PA] == out[JA]


def test_quadrature():
    f = lambda x, a: math.sqrt(1.0 - x * x)  # noqa: E731
    for n_gauss in (6, 10, 14):
        res = []
        for mod in (PA, JA):
            q = mod.Quadrature().set_enable_stats(True)
            q.n_gauss = n_gauss
            res.append((q.integrate(-1.0, 1.0, f), _counters(q.get_stats()),
                        q.stats.error_estimate))
        assert res[0] == res[1]
        assert res[0][0] == pytest.approx(math.pi / 2.0, abs=1e-10)
    for tf in PA.get_test_functions()[:6]:
        if tf.integral is None:
            continue
        v = PA.Quadrature().integrate(tf.range_a, tf.range_b, tf.f)
        assert v == pytest.approx(tf.integral, abs=1e-9), tf.name
    with pytest.raises(ValueError):
        PA.Quadrature().integrate(1.0, 1.0, lambda x, a: x)


def test_newton_solver_and_num_jacobian():
    import jax.numpy as jnp
    # test_algo.py: F(u) = [u0^2 + u1 - 3, u0 - u1 + 1] -> root (1, 2); the
    # port differentiates F by torch.func.jacfwd, the reference is given
    # F's Jacobian (its jax.jacfwd compiles for seconds on the first call)
    fp = lambda x, u, a: torch.stack([u[0] ** 2 + u[1] - 3.0,  # noqa: E731
                                      u[0] - u[1] + 1.0])
    fj = lambda x, u, a: jnp.stack([u[0] ** 2 + u[1] - 3.0,  # noqa: E731
                                    u[0] - u[1] + 1.0])
    jj = lambda x, u, a: jnp.array([[2.0 * u[0], 1.0],  # noqa: E731
                                    [1.0, -1.0]])
    for numerical in (False, True):
        sp_, sj = PA.NewtonSolver(2), JA.NewtonSolver(2)
        sp_.use_numerical_jacobian = sj.use_numerical_jacobian = numerical
        up = sp_.solve(np.array([2.0, 0.0]), fp, device=CPU)
        uj = sj.solve(np.array([2.0, 0.0]), fj, jac=jj)
        assert _counters(sp_.stats) == _counters(sj.stats)
        _close(up, uj, 1e-12)
        np.testing.assert_allclose(up.numpy(), [1.0, 2.0], atol=1e-9)
    # a seeded dense system A u + u^3 - b, A SPD (the smoke's problem),
    # against the same Newton iteration in numpy
    rng = np.random.default_rng(10)
    n = 12
    g = rng.standard_normal((n, n))
    a = g @ g.T / n + np.eye(n)
    b = rng.standard_normal(n)
    A, B = torch.as_tensor(a), torch.as_tensor(b)
    solver = PA.NewtonSolver(n)
    up = solver.solve(torch.zeros(n, dtype=torch.float64),
                      lambda x, u, _: A @ u + u ** 3 - B)
    u, its = np.zeros(n), 0
    while True:
        its += 1
        r = a @ u + u ** 3 - b
        if np.sqrt(np.sum((r / (1e-10 + 1e-10 * np.abs(u))) ** 2) / n) < 1:
            break
        u = u + np.linalg.solve(a + np.diag(3 * u ** 2), -r)
    assert _counters(solver.stats) == (its, its - 1, its)
    _close(up, u, 1e-12)
    fnp = lambda x, u, a: np.array([u[0] ** 2, u[0] * u[1]])  # noqa: E731
    assert np.array_equal(PA.num_jacobian(fnp, 0.0, np.array([2.0, 3.0])),
                          JA.num_jacobian(fnp, 0.0, np.array([2.0, 3.0])))


def test_smoke_lab_counters_are_the_reference():
    """chip_smoke.py's lab_path holds RootFinder, MinSolver and Quadrature
    on the card's host to these constants: the reference's counters."""
    import chip_smoke
    g4 = lambda x, a: x ** 4 - 1.0  # noqa: E731
    s = JA.RootFinder().set_enable_stats(True)
    roots = s.chebyshev(JA.InterpChebyshev(2, -2.0, 2.0).set_function(2, g4))
    s.refine(roots, -2.0, 2.0, g4)
    s.brent(2.0, 4.0, lambda x, a: math.sin(x))
    assert _counters(s.stats) == chip_smoke.LAB_ROOT_COUNTERS
    h = lambda x, a: (x - 2.0) ** 2 + 1.0 + 0.1 * math.sin(5 * x)  # noqa
    br = JA.MinBracketing().set_enable_stats(True)
    bk = br.basic(0.0, h)
    ms = JA.MinSolver().set_enable_stats(True)
    ms.brent(bk.a, bk.c, h)
    assert ((br.stats.n_function, br.stats.n_iterations),
            (ms.stats.n_function, ms.stats.n_iterations)) == \
        chip_smoke.LAB_MIN_COUNTERS
    q = JA.Quadrature().set_enable_stats(True)
    q.integrate(-1.0, 1.0, lambda x, a: math.sqrt(1.0 - x * x))
    assert (q.stats.n_function, q.stats.n_iterations) == \
        chip_smoke.LAB_QUAD_COUNTERS


def test_smoke_lab_path_checks_on_the_cpu(monkeypatch):
    """chip_smoke.py's lab_path checks, through its helpers on the CPU at
    a small size: every special function against its scipy oracle at the
    phase's tolerances and edge values (``lab_compare``); the helpers
    refuse what they should; the phase's plain Jacobi run (the one it
    holds the main path's launch to) is ``mat_eigen_sym_jacobi``'s."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "LAB_POINTS", 1 << 11)
    specs = cs.lab_special_specs()
    for i, (name, fn, ref, ins, kind, tol, _) in enumerate(specs):
        host = [cs.lab_inputs(e, lo, hi, cs.SEED + 17 * i + j)
                for j, (e, lo, hi) in enumerate(ins.values())]
        got = fn(*(torch.as_tensor(h) for h in host))
        assert got.shape == (cs.LAB_POINTS,), name
        cs.lab_compare(kind, got.numpy(), ref(*host), tol)
    assert set(cs.LAB_CPU_TOL) <= {s[0] for s in specs}
    with pytest.raises(AssertionError):
        cs.lab_check("err", 2e-12, cs.LAB_RES_TOL)
    with pytest.raises(AssertionError):
        cs.lab_compare("abs", np.array([np.nan, 0.0]), np.array([1.0, 0.0]),
                       1.0)
    with pytest.raises(AssertionError):
        cs.lab_compare("rel", np.array([np.inf]), np.array([-np.inf]), 1.0)
    with pytest.raises(AssertionError):
        cs.lab_counters("counters", (58, 0, 8), cs.LAB_ROOT_COUNTERS)
    w, V, _ = cs.jacobi_plain_sorted(6, 4)
    we, Ve = PD.mat_eigen_sym_jacobi(cs.lab_sym(6, 6), 4, device=CPU)
    assert torch.equal(w, we) and torch.equal(V, Ve)
