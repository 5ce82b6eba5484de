"""PDE tools of russell_tpu_torch against russell_tpu's, on the CPU.

``tests/test_pde.py`` is the checklist. The same inputs — the analytic
problems of ``problem_samples``, and problems whose coefficients, sources
and boundary values are drawn from a numpy seed — go through both
packages: grids, the equation handler, the Chebyshev points and
polynomials, the Lagrange interpolant's D1/D2 matrices, ``Fdm1d`` and
``Fdm2d`` (SPS and LMM; AUTO with the grid hint, which takes GRIDMF above
``dense_threshold``; ``Genie.GRIDMF`` and ``Genie.SPLU`` by name),
``Spc1d``, ``Spc2d``, ``SpcMap2d``, ``Transfinite2d`` and ``Metrics``.
Solutions are held to the reference's at rtol 1e-10 (the solvers' sums
round apart), host-side arrays copied from the reference exactly. The
port solves on ``device="cpu"``; the reference runs its own routes (DENSE
below ``dense_threshold``), so each port route is held to the same x.
f64, small sizes (grids <= 21², Spc <= 16).
"""

import math

import numpy as np
import pytest
import torch

import russell_tpu.algo.interp_lagrange as jinterp
import russell_tpu.math.chebyshev as jcheb
import russell_tpu.pde as J
import russell_tpu.sparse.factor as jfactor
import russell_tpu_torch.algo.interp_lagrange as pinterp
import russell_tpu_torch.math.chebyshev as pcheb
import russell_tpu_torch.pde as P
from russell_tpu.sparse.enums import Genie as JGenie
from russell_tpu_torch.sparse import factor as pfactor
from russell_tpu_torch.sparse.enums import Genie

# solutions: the two packages' LU factorizations and sums round apart
RTOL = 1e-10
# D1/D2 against the reference, relative to max|D| (both are the same numpy
# code: equal bits are expected; the bound holds up to N 24 and beyond)
D_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: torch's CPU build can deadlock in batched LAPACK
    calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


def test_grids_and_equation_handler():
    for args in ((0.0, 1.0, 0.0, 2.0, 3, 4), (-1.0, 1.0, 0.0, 1.0, 7, 5)):
        g, jg = P.Grid2d.new_uniform(*args), J.Grid2d.new_uniform(*args)
        assert np.array_equal(g.xx, jg.xx) and np.array_equal(g.yy, jg.yy)
        assert g.get_dx_dy() == jg.get_dx_dy()
        assert g.get_boundary_nodes() == jg.get_boundary_nodes()
        for a, b in zip(g.coords_arrays(), jg.coords_arrays()):
            assert np.array_equal(a, b)
        assert [g.is_corner(m) for m in range(g.size())] == \
            [jg.is_corner(m) for m in range(jg.size())]
    c, jc = (P.Grid2d.new_chebyshev_gauss_lobatto(9, 6),
             J.Grid2d.new_chebyshev_gauss_lobatto(9, 6))
    assert c.is_chebyshev_gauss_lobatto()
    assert np.array_equal(c.xx, jc.xx) and np.array_equal(c.yy, jc.yy)
    assert c.get_dx_dy() is None
    g1, jg1 = (P.Grid1d.new_chebyshev_gauss_lobatto(11),
               J.Grid1d.new_chebyshev_gauss_lobatto(11))
    assert np.array_equal(g1.xx, jg1.xx) and g1.get_dx() is None
    assert P.Grid1d.new_uniform(0.0, 2.0, 5).get_dx() == 0.5
    rng = np.random.default_rng(11)
    neq = 40
    pres = rng.integers(0, neq, 15)
    eq, jeq = P.EquationHandler(neq), J.EquationHandler(neq)
    eq.recompute(pres)
    jeq.recompute(pres)
    assert np.array_equal(eq.e_to_iu, jeq.e_to_iu)
    assert np.array_equal(eq.e_to_ip, jeq.e_to_ip)
    assert eq.unknown() == jeq.unknown()
    assert eq.prescribed() == jeq.prescribed()
    with pytest.raises(ValueError):
        eq.iu(eq.prescribed()[0])


def test_chebyshev_matches_reference():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1.0, 1.0, 16), [-1.0, 1.0, 1.3, -1.7]])
    for name in ("chebyshev_tn", "chebyshev_tn_deriv1",
                 "chebyshev_tn_deriv2", "chebyshev_un",
                 "chebyshev_un_deriv1", "chebyshev_un_deriv2"):
        for n in (0, 2, 5):
            got = getattr(pcheb, name)(n, torch.as_tensor(x)).numpy()
            want = np.asarray(getattr(jcheb, name)(n, x))
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}({n})")
            # a numpy array or a float goes to the device asked for
            # (the card by default)
            got = getattr(pcheb, name)(n, x, device="cpu")
            assert got.device.type == "cpu"
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12, err_msg=f"{name}({n})")
            assert float(getattr(pcheb, name)(n, float(x[0]),
                                              device="cpu")) == \
                pytest.approx(float(want[0]), rel=1e-12, abs=1e-12)
    for nn in (1, 6, 13):
        assert np.array_equal(pcheb.chebyshev_gauss_points(nn),
                              jcheb.chebyshev_gauss_points(nn))
        assert np.array_equal(pcheb.chebyshev_lobatto_points(nn),
                              jcheb.chebyshev_lobatto_points(nn))


@pytest.mark.parametrize("nn", [4, 16, 24, 40])
def test_lagrange_d1_d2_and_eval(nn):
    """D1 and D2 against the reference at 1e-12 relative to max|D| up to N
    24; at N 40 (D2's conditioning grows like N^4) the same bound holds,
    since both packages run the same numpy code."""
    for grid in jinterp.InterpGrid:
        jp = jinterp.InterpLagrange(nn, jinterp.InterpParams(grid_type=grid))
        pp = pinterp.InterpLagrange(nn, pinterp.InterpParams(
            grid_type=pinterp.InterpGrid[grid.name]))
        jp.calc_dd2_matrix()
        pp.calc_dd2_matrix()
        for d, jd in ((pp.get_dd1(), jp.get_dd1()),
                      (pp.get_dd2(), jp.get_dd2())):
            _close(d, jd, D_RTOL)
        assert np.array_equal(pp.get_lambda(), jp.get_lambda())
    rng = np.random.default_rng(nn)
    uu = rng.standard_normal(nn + 1)
    for x in (float(rng.uniform(-1.0, 1.0)), float(pp.xx[1])):
        assert float(pp.eval(x, torch.as_tensor(uu))) == pytest.approx(
            float(jp.eval(x, uu)), rel=1e-12, abs=1e-12)
        assert pp.eval_deriv1(x, uu) == pytest.approx(
            jp.eval_deriv1(x, uu), rel=1e-12, abs=1e-12)
        assert pp.eval_deriv2(x, uu) == pytest.approx(
            jp.eval_deriv2(x, uu), rel=1e-12, abs=1e-12)


def _random_problem_2d(seed):
    """Seeded coefficients, source and Dirichlet values (both packages'
    BC objects): kx, ky, alpha, s(x, y) = c0 + c1 x + c2 y + c3 x y and
    phi = d0 + d1 x + d2 y on Xmin/Xmax/Ymin, zero flux on Ymax."""
    rng = np.random.default_rng(seed)
    kx, ky = rng.uniform(0.5, 2.0, 2)
    alpha = float(rng.uniform(0.0, 1.0))
    c = rng.standard_normal(4)
    d = rng.standard_normal(3)
    source = lambda x, y: c[0] + c[1] * x + c[2] * y + c[3] * x * y
    phi = lambda x, y: d[0] + d[1] * x + d[2] * y
    bcs = []
    for pkg in (J, P):
        ebcs, nbcs = pkg.EssentialBcs2d(), pkg.NaturalBcs2d()
        for side in ("XMIN", "XMAX", "YMIN"):
            ebcs.set(getattr(pkg.Side, side), phi)
        nbcs.set(pkg.Side.YMAX, lambda x, y: 0.0)
        bcs.append((ebcs, nbcs))
    return float(kx), float(ky), alpha, source, bcs


def _fdm2d(pkg, n, prob, genie=None, **kw):
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, *_rest) = prob
    g = pkg.Grid2d.new_uniform(xmin, xmax, ymin, ymax, n, n)
    fdm = pkg.Fdm2d(g, ebcs, nbcs, kx, ky, **kw)
    if genie is not None:
        fdm.set_solver_options(genie)
    return fdm


def test_fdm_1d_sps_lmm_match_reference():
    for prob, alpha in ((J.problem_samples.d1_problem_01, 0.0),
                        (J.problem_samples.d1_problem_03, None)):
        jprob = prob()
        pprob = getattr(P.problem_samples, prob.__name__)()
        if alpha is None:
            xmin, xmax, kx, alpha, *_ = jprob
            jbc, pbc = jprob[4:7], pprob[4:7]
        else:
            xmin, xmax, kx = jprob[:3]
            jbc, pbc = jprob[3:6], pprob[3:6]
        jf = J.Fdm1d(J.Grid1d.new_uniform(xmin, xmax, 21), jbc[0], jbc[1], kx)
        pf = P.Fdm1d(P.Grid1d.new_uniform(xmin, xmax, 21), pbc[0], pbc[1], kx,
                     device="cpu")
        want = jf.solve_sps(alpha, jbc[2])
        _close(pf.solve_sps(alpha, pbc[2]), want)
        _close(pf.solve_lmm(alpha, pbc[2]), jf.solve_lmm(alpha, jbc[2]))
        _close(pf.solve_lmm(alpha, pbc[2]), want, 1e-9)


@pytest.mark.parametrize("case", ["problem_01", "problem_01_neumann",
                                  "problem_02", "seeded"])
def test_fdm_2d_matches_reference(case):
    if case == "seeded":
        kx, ky, alpha, src, (jbc, pbc) = _random_problem_2d(1)
        jprob = (0.0, 1.0, 0.0, 1.0, kx, ky, *jbc)
        pprob = (0.0, 1.0, 0.0, 1.0, kx, ky, *pbc)
        jsrc = psrc = src
    else:
        name, *arg = {"problem_01": ("d2_problem_01", True),
                      "problem_01_neumann": ("d2_problem_01", False),
                      "problem_02": ("d2_problem_02",)}[case]
        jprob = getattr(J.problem_samples, name)(*arg)
        pprob = getattr(P.problem_samples, name)(*arg)
        alpha, jsrc, psrc = 0.0, jprob[8], pprob[8]
    jf = _fdm2d(J, 13, jprob)
    pf = _fdm2d(P, 13, pprob, device="cpu")
    want = jf.solve_sps(alpha, jsrc)
    _close(pf.solve_sps(alpha, psrc), want)
    # LMM's saddle system through the port's AUTO (DENSE at this size)
    _close(pf.solve_lmm(alpha, psrc), jf.solve_lmm(alpha, jsrc))
    _close(pf.solve_lmm(alpha, psrc), want, 1e-9)
    for a, b in zip(pf.get_matrices_sps(alpha), jf.get_matrices_sps(alpha)):
        if b is not None:
            assert np.array_equal(a.as_dense(), b.as_dense())


@pytest.mark.parametrize("genie", [Genie.GRIDMF, Genie.SPLU])
def test_fdm_2d_gridmf_and_splu_match_reference(genie):
    # the port's GRIDMF (the route AUTO takes above dense_threshold, with
    # the interior grid hint) and SPLU against the reference's solution
    jprob = J.problem_samples.d2_problem_01(True)
    pprob = P.problem_samples.d2_problem_01(True)
    want = _fdm2d(J, 21, jprob).solve_sps(0.0, jprob[8])
    pf = _fdm2d(P, 21, pprob, genie, device="cpu")
    _close(pf.solve_sps(0.0, pprob[8]), want)


def test_fdm_2d_auto_takes_gridmf_above_dense_threshold():
    # the SPS K-bar of a 37 x 37 grid (1,225 unknowns > 1,200) with its
    # grid hint: AUTO plans GRIDMF in both packages (host analysis only)
    jf = _fdm2d(J, 37, J.problem_samples.d2_problem_01(True))
    pf = _fdm2d(P, 37, P.problem_samples.d2_problem_01(True), device="cpu")
    hint = pf._sps_grid_hint()
    assert hint == jf._sps_grid_hint() == (35, 35, 1)
    ii, jj, _ = pf.get_matrices_sps(0.0)[0].triplets()
    plan = pfactor.analyze(35 * 35, ii, jj, genie=Genie.AUTO, grid=hint)
    jplan = jfactor.analyze(35 * 35, ii, jj, genie=JGenie.AUTO, grid=hint,
                            mixed_precision=False)
    assert plan.genie == Genie.GRIDMF and jplan.genie == JGenie.GRIDMF
    assert len(plan.gridmf_plan.levels) == len(jplan.gridmf_plan.levels)
    assert np.array_equal(plan.gridmf_plan.entry_perm,
                          jplan.gridmf_plan.entry_perm)
    # a periodic or Neumann grid has no hint: AUTO routes on the pattern
    prob = P.problem_samples.d2_problem_01(False)
    assert _fdm2d(P, 37, prob, device="cpu")._sps_grid_hint() is None


def test_spc_1d_matches_reference():
    for name in ("d1_problem_01", "d1_problem_04b"):
        jp = getattr(J.problem_samples, name)()
        pp = getattr(P.problem_samples, name)()
        xmin, xmax, kx = jp[:3]
        js = J.Spc1d(xmin, xmax, 12, jp[3], jp[4], kx)
        ps = P.Spc1d(xmin, xmax, 12, pp[3], pp[4], kx, device="cpu")
        want = js.solve_sps(0.0, jp[5])
        _close(ps.solve_sps(0.0, pp[5]), want)
        _close(ps.solve_lmm(0.0, pp[5]), js.solve_lmm(0.0, jp[5]))
        _close(ps.calculate_flow_vectors(want),
               js.calculate_flow_vectors(want))


@pytest.mark.parametrize("case", ["problem_07", "problem_06", "seeded"])
def test_spc_2d_matches_reference(case):
    if case == "seeded":
        kx, ky, alpha, src, (jbc, pbc) = _random_problem_2d(2)
        jprob = (-1.0, 1.0, 0.0, 2.0, kx, ky, *jbc, src)
        pprob = (-1.0, 1.0, 0.0, 2.0, kx, ky, *pbc, src)
    else:
        alpha = 0.0
        name = f"d2_{case}"
        jprob = getattr(J.problem_samples, name)()
        pprob = getattr(P.problem_samples, name)()
    js = J.Spc2d(*jprob[:4], 14, 12, *jprob[6:8], *jprob[4:6])
    ps = P.Spc2d(*pprob[:4], 14, 12, *pprob[6:8], *pprob[4:6], device="cpu")
    want = js.solve_sps(alpha, jprob[8])
    _close(ps.solve_sps(alpha, pprob[8]), want)
    _close(ps.solve_lmm(alpha, pprob[8]), js.solve_lmm(alpha, jprob[8]))
    for a, b in zip(ps.calculate_flow_vectors(want),
                    js.calculate_flow_vectors(want)):
        _close(a, b)


def _quarter_ring(pkg):
    """Quarter annulus r in [1, 2], theta in [0, pi/2]
    (tests/test_pde.py)."""
    a, b_ = 1.0, 2.0

    def th(s):
        return (s + 1.0) * math.pi / 4.0

    q = math.pi / 4
    B = [lambda s: np.array([a * math.cos(th(s)), a * math.sin(th(s))]),
         lambda s: np.array([b_ * math.cos(th(s)), b_ * math.sin(th(s))]),
         lambda r: np.array([(a + b_) / 2 + (b_ - a) / 2 * r, 0.0]),
         lambda r: np.array([0.0, (a + b_) / 2 + (b_ - a) / 2 * r])]
    dB = [lambda s: np.array([-a * math.sin(th(s)) * q,
                              a * math.cos(th(s)) * q]),
          lambda s: np.array([-b_ * math.sin(th(s)) * q,
                              b_ * math.cos(th(s)) * q]),
          lambda r: np.array([(b_ - a) / 2, 0.0]),
          lambda r: np.array([0.0, (b_ - a) / 2])]
    ddB = [lambda s: np.array([-a * math.cos(th(s)) * q ** 2,
                               -a * math.sin(th(s)) * q ** 2]),
           lambda s: np.array([-b_ * math.cos(th(s)) * q ** 2,
                               -b_ * math.sin(th(s)) * q ** 2]),
           lambda r: np.array([0.0, 0.0]),
           lambda r: np.array([0.0, 0.0])]
    return pkg.Transfinite2d(B, dB, ddB)


def test_transfinite_and_metrics_match_reference():
    tr, jtr = _quarter_ring(P), _quarter_ring(J)
    rng = np.random.default_rng(9)
    for r, s in rng.uniform(-1.0, 1.0, (5, 2)):
        for a, b in zip(tr.point_and_derivs(r, s, second=True),
                        jtr.point_and_derivs(r, s, second=True)):
            assert np.array_equal(a, b)
        m, jm = P.Metrics(2, homogeneous=False), J.Metrics(2, False)
        _, dr, ds, ddr, dds, ddrs = tr.point_and_derivs(r, s, second=True)
        assert m.calculate_2d(dr, ds, ddr, dds, ddrs) == \
            jm.calculate_2d(dr, ds, ddr, dds, ddrs)
        assert np.array_equal(m.christoffel_second, jm.christoffel_second)
        assert m.ell_coefficient_for_laplacian(1) == \
            jm.ell_coefficient_for_laplacian(1)
    pts, tris = tr.triangulate(4, 3)
    jpts, jtris = jtr.triangulate(4, 3)
    assert np.array_equal(pts, jpts) and np.array_equal(tris, jtris)


def test_spc_map_2d_ring_matches_reference():
    # tests/test_pde.py::test_spc_map_2d_laplace_on_ring at 12 x 12, with a
    # Neumann side for the flux rows
    ana = lambda x, y: math.log(math.hypot(x, y)) / math.log(2.0)
    out = []
    for pkg in (J, P):
        ebcs, nbcs = pkg.EssentialBcs2d(), pkg.NaturalBcs2d()
        ebcs.set(pkg.Side.XMIN, lambda x, y: 0.0)
        ebcs.set(pkg.Side.XMAX, lambda x, y: 1.0)
        ebcs.set(pkg.Side.YMIN, ana)
        nbcs.set(pkg.Side.YMAX, lambda x, y: 0.0)
        kw = {} if pkg is J else {"device": "cpu"}
        spc = pkg.SpcMap2d(12, 12, _quarter_ring(pkg), ebcs, nbcs, k=1.0,
                           **kw)
        out.append((spc.solve_sps(0.0, lambda x, y: 0.0),
                    spc.solve_lmm(0.0, lambda x, y: 0.0),
                    spc))
    (ja, jl, js), (pa, pl, ps) = out
    _close(pa, ja)
    _close(pl, jl)
    for a, b in zip(ps.calculate_flow_vectors(pa),
                    js.calculate_flow_vectors(ja)):
        _close(a, b)
    err = 0.0
    for m in range(ps.grid.size()):
        err = max(err, abs(pa[m] - ana(*ps.map_coord(m))))
    assert err < 1e-9


def test_solvers_resolve_device():
    prob = P.problem_samples.d2_problem_01(True)
    g = P.Grid2d.new_uniform(0.0, 1.0, 0.0, 1.0, 5, 5)
    assert P.Fdm2d(g, prob[6], prob[7], 1.0, 1.0, device="cpu").device == \
        torch.device("cpu")
    if not torch.cuda.is_available():
        for make in (lambda: P.Fdm2d(g, prob[6], prob[7], 1.0, 1.0),
                     lambda: P.Spc2d(0.0, 1.0, 0.0, 1.0, 4, 4, prob[6],
                                     prob[7], 1.0, 1.0)):
            with pytest.raises(RuntimeError):
                make()              # the card by default: no fallback
