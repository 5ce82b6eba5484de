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
  n 2, 6, 17 and 32: 1e-12 (the port rotates in a parallel order, the
  reference in the cyclic one, so only the values agree; its jitted scan
  may also contract multiply-adds on the CPU); the CUDA kernel's order,
  arithmetic and storage, walked in numpy, equal the plain version's bit
  for bit;
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


@pytest.mark.parametrize("n", [2, 6, 17, 32])
def test_jacobi_plain_version_matches_reference(n):
    a = np.array([[2.0, 1.0], [1.0, 2.0]]) if n == 2 else _sym(n, n)
    w, V = PD.mat_eigen_sym_jacobi(torch.as_tensor(a))
    jw, jV = (np.asarray(t) for t in JD.mat_eigen_sym_jacobi(a))
    _close(w, jw, 1e-12)
    _close(V.numpy() @ np.diag(w.numpy()) @ V.numpy().T, a, 1e-12)
    _close(np.abs(V.numpy()), np.abs(jV), 1e-12)
    if n == 2:
        _close(w, [1.0, 3.0], 1e-15)


def _converged_sweeps(run, a, tol=1e-14):
    """The fewest sweeps after which ``run(a, sweeps)``'s eigenvalues equal
    its 30-sweep values to ``tol`` relative to max|w|."""
    full = run(a, 30)
    scale = np.abs(full).max()
    for s in range(1, 30):
        w = run(a, s)
        if np.abs(w - full).max() <= tol * scale:
            return s, w
    return 30, full


def _port_w(a, sweeps):
    return PD.mat_eigen_sym_jacobi(torch.as_tensor(a), sweeps)[0].numpy()


def _ref_w(a, sweeps):
    return np.asarray(JD.mat_eigen_sym_jacobi(a, sweeps)[0])


@pytest.mark.parametrize("n", [2, 5, 12, 32])
def test_jacobi_converged_values_match_reference(n):
    """From the fewest sweeps at which both the port's parallel order and
    the reference's cyclic order have converged, the values agree to
    1e-12."""
    a = np.array([[2.0, 1.0], [1.0, 2.0]]) if n == 2 else _sym(n, n)
    sp, _ = _converged_sweeps(_port_w, a)
    # the reference is run at the port's count and above it only, each
    # sweep count being a compile of its own
    s, full = sp, _ref_w(a, 30)
    while True:
        wj = _ref_w(a, s)
        if np.abs(wj - full).max() <= 1e-14 * np.abs(full).max():
            break
        s += 1
    _close(_port_w(a, s), wj, 1e-12)


def test_jacobi_truncated_run_differs_from_reference():
    """Cut off before convergence, the two rotation orders give other
    values (measured: 3.2e-2 of max|w| at n 12 after 2 sweeps)."""
    a = _sym(12, 12)
    wp, wj = _port_w(a, 2), _ref_w(a, 2)
    gap = np.abs(wp - wj).max() / np.abs(wj).max()
    assert gap > 1e-3, gap
    _close(_port_w(a, 30), _ref_w(a, 30), 1e-12)


@pytest.mark.parametrize("n", range(2, 10))
def test_jacobi_rounds_visit_every_pair_once_a_sweep(n):
    """The parallel order: n - 1 rounds a sweep (n even; n for odd n),
    each of disjoint pairs p < q, every pair once."""
    rounds = matrix_ops._jacobi_rounds(n)
    assert len(rounds) == n - 1 + n % 2
    seen = []
    for p, q in rounds:
        assert np.all(p < q) and np.all(q < n)
        assert len(set(np.concatenate((p, q)).tolist())) == 2 * len(p)
        seen += list(zip(p.tolist(), q.tolist()))
    assert sorted(seen) == [(i, j) for i in range(n) for j in range(i + 1, n)]


def _kernel_walk(a, sweeps, cluster):
    """jacobi_eig.cu in numpy, CTA by CTA, with its storage: C = ``cluster``
    CTAs hold slots [c h / C, (c + 1) h / C), each CTA's seats one arc of
    the ring or two, an arc of len positions in len + 1 storage rows used
    as a circular buffer (the row at arc offset o in round R in row
    (o + R) mod (len + 1)), the row that enters an arc read from the next
    arc's storage. A round: each slot's rows and (c, s), then every 2 x 2
    block (rows of slot I, columns of slot J: the row stage, then the
    column stage) and V^T's rows, read where the rows lie and written where
    they go. Checks that no row the round writes into is one it reads
    from another place, so that the kernel may update in place."""
    n = a.shape[0]
    m = n + n % 2
    h, ring, C = m // 2, m - 1, cluster
    lo = [c * h // C for c in range(C + 1)]
    S = [lo[c + 1] - lo[c] for c in range(C)]
    # storage rows a CTA: len + 1 an arc, and CTA 0's fixed row
    rows = max(2 * s + (1 if c in (0, C - 1) else 2) for c, s in enumerate(S))
    store = np.full((C, rows, 2, n), np.nan)   # [CTA, row, A / V^T, :]

    def arc(c, which):                         # (CTA, first row, len)
        if c == 0:
            return 0, 0, 2 * S[0] - 1
        if c == C - 1:
            return c, 0, 2 * S[c]
        return (c, 0, S[c]) if which == 0 else (c, S[c] + 1, S[c])

    def next_arc(c, which):
        if c == 0:
            return arc(0 if C == 1 else 1, 0)
        if c == C - 1 or which == 1:
            return arc(c - 1, 0 if c == 1 else 1)
        return arc(c + 1, 0)

    def seat(c, J, top, R):                    # (index, source, destination)
        if top and J == 0:
            return m - 1, (0, 2 * S[0]), (0, 2 * S[0])
        hi = lo[c + 1]
        if c == 0:
            which, off = 0, hi - 1 + J if top else hi - 1 - J
        elif c == C - 1:
            which, off = 0, J - lo[c] if top else S[c] + hi - 1 - J
        else:
            which, off = (0, J - lo[c]) if top else (1, hi - 1 - J)
        _, base, ln = arc(c, which)
        dst = src = (c, base + (off + R) % (ln + 1))
        if off == ln - 1 and R > 0:
            nc, nb, nl = next_arc(c, which)
            src = (nc, nb + (R - 1) % (nl + 1))
        return ((R + J) if top else (R - J)) % ring, src, dst

    def seats(R):
        for c in range(C):
            for J in range(lo[c], lo[c + 1]):
                for top in (True, False):
                    x, src, dst = seat(c, J, top, R)
                    if x < n:
                        yield x, src, dst

    for x, _, dst in seats(0):
        store[dst] = a[x], np.eye(n)[x]
    for R in range(sweeps * ring):
        slots, cs = [], {}
        for c in range(C):
            for J in range(lo[c], lo[c + 1]):
                (xt, ts, td), (xb, bs, bd) = (seat(c, J, top, R)
                                              for top in (True, False))
                if xt > xb:
                    (xt, ts, td), (xb, bs, bd) = (xb, bs, bd), (xt, ts, td)
                slots.append((J, xt, xb, ts, bs, td, bd))
                if xb < n:
                    cs[J] = tuple(float(v[0]) for v in matrix_ops._rotations(
                        *(np.array([store[ts][0][xb]]),
                          np.array([store[ts][0][xt]]),
                          np.array([store[bs][0][xb]]))))
        dsts = [d for sl in slots for d, s in ((sl[5], sl[3]), (sl[6], sl[4]))
                if sl[1 if d == sl[5] else 2] < n]
        moved = {s for sl in slots for s, d in ((sl[3], sl[5]), (sl[4], sl[6]))
                 if s != d}
        assert len(set(dsts)) == len(dsts) and not moved & set(dsts)
        old = store.copy()
        col = [(min(i, j), max(i, j)) for i, j in
               ((m - 1 if J == 0 else (R + J) % ring, (R - J) % ring)
                for J in range(h))]
        for I, p, q, ps, qs, pd, qd in slots:
            row2 = q < n
            for J, (pj, qj) in enumerate(col):
                col2 = qj < n
                x = [old[ps][0][pj], old[ps][0][qj] if col2 else 0.0,
                     old[qs][0][pj] if row2 else 0.0,
                     old[qs][0][qj] if row2 and col2 else 0.0]
                if row2:
                    ci, si = cs[I]
                    x = [x[0] * ci - x[2] * si, x[1] * ci - x[3] * si,
                         x[0] * si + x[2] * ci, x[1] * si + x[3] * ci]
                if col2:
                    cj, sj = cs[J]
                    x = [x[0] * cj - x[1] * sj, x[0] * sj + x[1] * cj,
                         x[2] * cj - x[3] * sj, x[2] * sj + x[3] * cj]
                store[pd][0][pj] = x[0]
                if col2:
                    store[pd][0][qj] = x[1]
                if row2:
                    store[qd][0][pj] = x[2]
                if row2 and col2:
                    store[qd][0][qj] = x[3]
            vp = old[ps][1]
            if row2:
                vq = old[qs][1]
                store[pd][1] = vp * cs[I][0] - vq * cs[I][1]
                store[qd][1] = vp * cs[I][1] + vq * cs[I][0]
            else:
                store[pd][1] = vp
    w, V = np.full(n, np.nan), np.full((n, n), np.nan)
    for x, _, dst in seats(max(sweeps * ring - 1, 0)):
        w[x], V[:, x] = store[dst][0][x], store[dst][1]
    return w, V


@pytest.mark.parametrize("n,cluster,sweeps", [(2, 1, 30), (7, 1, 30),
                                              (7, 4, 30), (17, 8, 4),
                                              (33, 16, 3)])
def test_jacobi_kernel_order_equals_plain_version(n, cluster, sweeps):
    a = np.array([[2.0, 1.0], [1.0, 2.0]]) if n == 2 else _sym(n, 3 * n)
    a[0, n - 1] = a[n - 1, 0] = 0.0  # a vanishing a_pq: t = 0
    w, V = matrix_ops._jacobi_eig_plain(torch.as_tensor(a), sweeps)
    kw, kV = _kernel_walk(a, sweeps, cluster)
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
    holds the main path's launches to, in process) is
    ``mat_eigen_sym_jacobi``'s, and other bits are refused."""
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
    held = cs.jacobi_main_held(6, {6: (we, Ve)}, 4, device=CPU)
    assert held["bit_identical"] and held["max_abs_err"] == 0.0
    with pytest.raises(AssertionError):
        cs.jacobi_main_held(6, {6: (we, -Ve)}, 4, device=CPU)
    assert cs.jacobi_work(7, 2, "cta")[2] == {
        "rounds": 2 * 7, "cta_barriers": 2 * 2 * 7 + 3, "cluster_barriers": 0}
    assert cs.jacobi_work(7, 2, "cluster")[2] == {
        "rounds": 2 * 7, "cta_barriers": 2 * 7 + 1,
        "cluster_barriers": 2 * 2 * 7 + 2}
