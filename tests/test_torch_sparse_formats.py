"""Sparse formats and BSR products in russell_tpu_torch against russell_tpu's
(the reference).

The same inputs, made from a seed with numpy, go through both packages on
the CPU in f64 (``device="cpu"``). Host numpy code (COO, samples,
MatrixMarket, VerifyLinSys, the BSR conversion and the SpGEMM plan) must
give identical outputs. The products run as gather + ``index_add_`` (CSR,
CSC) or as the kernels' plain PyTorch versions (BSR, SpGEMM) here; the
reference's Pallas kernels run in interpret mode, as
tests/test_sparse_formats.py runs them. The CUDA kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import russell_tpu_torch
from russell_tpu.sparse import kernels as jk
from russell_tpu.sparse import samples as js
from russell_tpu.sparse.coo import CooMatrix as JCoo
from russell_tpu.sparse.csc import CscMatrix as JCsc
from russell_tpu.sparse.csr import CsrMatrix as JCsr
from russell_tpu.sparse.enums import MMsym as JMMsym, Sym as JSym
from russell_tpu.sparse.matrix_market import (
    read_matrix_market as j_read, write_matrix_market as j_write)
from russell_tpu.sparse.verify import VerifyLinSys as JVerify
from russell_tpu_torch import interop
from russell_tpu_torch.ode import Method, OdeSolver, Params
from russell_tpu_torch.ode import samples as tode_samples
from russell_tpu_torch.sparse import kernels as tk
from russell_tpu_torch.sparse import samples as ts
from russell_tpu_torch.sparse import (CooMatrix, CscMatrix, CsrMatrix, Genie,
                                      MMsym, Sym, VerifyLinSys,
                                      read_matrix_market,
                                      write_matrix_market)

torch.set_num_threads(2)

CPU = "cpu"
# products summed by index_add_ against XLA's segment_sum / einsum: the
# order of the f64 sums may differ
RTOL = 1e-13
# the BSR products against the reference's interpret-mode Pallas kernels,
# as tests/test_sparse_formats.py:186-206 holds them
BSR_ATOL = 1e-11

FIXED = ["tiny_1x1", "complex_tiny_1x1", "positive_definite_3x3_lower",
         "positive_definite_3x3_upper", "positive_definite_3x3_full",
         "complex_symmetric_3x3_lower", "complex_symmetric_3x3_full",
         "lower_symmetric_5x5", "unsymmetric_3x3", "umfpack_unsymmetric_5x5",
         "umfpack_complex_unsymmetric_5x5", "mkl_unsymmetric_5x5",
         "block_unsymmetric_5x5", "mkl_positive_definite_5x5_lower",
         "mkl_positive_definite_5x5_upper", "mkl_symmetric_5x5_lower",
         "mkl_symmetric_5x5_upper", "mkl_symmetric_5x5_full",
         "rectangular_1x2", "rectangular_1x7", "rectangular_7x1",
         "rectangular_3x4", "complex_rectangular_4x3"]


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _coo_equal(a, b):
    assert (a.nrow, a.ncol, a.nnz, a.sym.name, a.dtype) == (
        b.nrow, b.ncol, b.nnz, b.sym.name, b.dtype)
    for x, y in zip(a.triplets(), b.triplets()):
        np.testing.assert_array_equal(x, y)


def _vector(n, dtype, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        u = u + 1j * rng.standard_normal(n)
    return u


# -- samples, COO, CSR, CSC ---------------------------------------------------


@pytest.mark.parametrize("name", FIXED)
def test_fixed_sample_formats_and_products(name):
    jcoo, jcsc, jcsr, jdet = getattr(js, name)()
    coo, csc, csr, det = getattr(ts, name)(CPU)
    assert det == jdet
    _coo_equal(coo, jcoo)
    np.testing.assert_array_equal(coo.as_dense(), jcoo.as_dense())
    assert coo.get_info()[:3] == jcoo.get_info()[:3]
    for ours, ref in ((csr, jcsr), (csc, jcsc)):
        assert (ours.nrow, ours.ncol, ours.nnz) == (ref.nrow, ref.ncol,
                                                    ref.nnz)
        np.testing.assert_array_equal(ours.indptr, ref.indptr)
        np.testing.assert_array_equal(ours.indices, ref.indices)
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(ours.to_dense(), ref.to_dense())
    u = _vector(coo.ncol, coo.dtype, 7)
    w = _vector(coo.nrow, coo.dtype, 8)
    # host COO products: the same numpy code
    np.testing.assert_array_equal(coo.mat_vec_mul(u), jcoo.mat_vec_mul(u))
    np.testing.assert_array_equal(coo.mat_t_vec_mul(w),
                                  jcoo.mat_t_vec_mul(w))
    _close(csr.mat_vec_mul(u), jcsr.mat_vec_mul(jnp.asarray(u)))
    _close(csc.mat_vec_mul(u), jcsc.mat_vec_mul(jnp.asarray(u)))
    _close(csr.mat_t_vec_mul(w), jcsr.mat_t_vec_mul(jnp.asarray(w)))
    # CSC from CSR, on the values' device
    c2, j2 = CscMatrix.from_csr(csr), JCsc.from_csr(jcsr)
    np.testing.assert_array_equal(c2.indices, j2.indices)
    np.testing.assert_array_equal(c2.data.numpy(), np.asarray(j2.data))


@pytest.mark.parametrize("gen,args", [
    ("laplacian_2d", (7,)), ("laplacian_2d", (5, 2.0, 0.5)),
    ("laplacian_3d", (4,)), ("laplacian_3d", (3, 0.5)),
    ("irregular_geometric", (300, 3))])
def test_generators_give_the_same_triplets(gen, args):
    _coo_equal(getattr(ts, gen)(*args), getattr(js, gen)(*args))


def _assemble(cls, a, b):
    """alpha A, alpha A + beta B and their complex counterparts."""
    c = cls(5, 5, 100)
    c.assign(2.5, a)
    d = cls(5, 5, 100)
    d.add(2.0, a, -0.5, b)
    k = cls(5, 5, 100, dtype=np.complex128)
    k.assign_real(2.0, 3.0, a)
    k2 = cls(5, 5, 100, dtype=np.complex128)
    k2.add_real(2.0, 3.0, a, -1.0, b)
    return c, d, k, k2


def test_coo_construction_and_assembly():
    rng = np.random.default_rng(3)
    ii = rng.integers(0, 6, 20)
    jj = rng.integers(0, 4, 20)
    vv = rng.standard_normal(20)
    pairs = [(CooMatrix.from_arrays(6, 4, ii, jj, vv),
              JCoo.from_arrays(6, 4, ii, jj, vv))]
    dense = rng.standard_normal((5, 5)) * (rng.random((5, 5)) < 0.5)
    for sym in (Sym.NO, Sym.YES_LOWER, Sym.YES_UPPER):
        pairs.append((CooMatrix.from_dense(dense, sym),
                      JCoo.from_dense(dense, JSym[sym.name])))
    for ours, ref in pairs:
        _coo_equal(ours, ref)
        np.testing.assert_array_equal(ours.as_dense(), ref.as_dense())
    a, b = CooMatrix(6, 6, 10), JCoo(6, 6, 10)
    for m in (a, b):
        m.put_lagrange_block(0, 3, [1.5, -2.0])
        m.put(5, 0, 4.0)
    _coo_equal(a, b)
    (m5, j5), (n5, k5) = pairs[1], pairs[2]
    for x, y in zip(_assemble(CooMatrix, m5, n5), _assemble(JCoo, j5, k5)):
        _coo_equal(x, y)
    m5.reset()
    assert m5.nnz == 0
    for bad in (lambda: CooMatrix(2, 2, 1, Sym.YES_LOWER).put(0, 1, 1.0),
                lambda: CooMatrix.from_arrays(2, 2, [0], [2], [1.0]),
                lambda: CooMatrix.from_arrays(2, 2, [0], [1], [1.0],
                                              Sym.YES_LOWER),
                lambda: CooMatrix(2, 3, 1, Sym.YES_LOWER)):
        with pytest.raises(ValueError):
            bad()


def test_csr_values_from_coo_and_from_dense():
    rng = np.random.default_rng(4)
    n = 9
    ii = rng.integers(0, n, 40)
    jj = rng.integers(0, n, 40)
    vv = rng.standard_normal(40)          # duplicates summed
    coo, jcoo = (CooMatrix.from_arrays(n, n, ii, jj, vv),
                 JCoo.from_arrays(n, n, ii, jj, vv))
    csr, jcsr = CsrMatrix.from_coo(coo, CPU), JCsr.from_coo(jcoo)
    for f in ("indptr", "indices", "row_ids", "coo_perm", "coo_seg"):
        np.testing.assert_array_equal(getattr(csr, f), getattr(jcsr, f))
    assert csr.coo_nnz == jcsr.coo_nnz == 40
    new = rng.standard_normal(40)
    got = csr.with_values(csr.values_from_coo(new))
    want = jcsr.with_values(jcsr.values_from_coo(jnp.asarray(new)))
    _close(got.data, want.data)
    _close(got.mat_vec_mul(np.ones(n)), want.mat_vec_mul(jnp.ones(n)))
    dense = coo.as_dense()
    _close(CsrMatrix.from_dense(dense, device=CPU).to_dense(),
           JCsr.from_dense(dense).to_dense())
    with pytest.raises(TypeError):       # values must be a tensor
        CsrMatrix(n, n, csr.indptr, csr.indices, np.zeros(csr.nnz))
    with pytest.raises(ValueError):      # no COO map without from_coo
        CsrMatrix(n, n, csr.indptr, csr.indices, csr.data).values_from_coo(
            new)


def test_verify_lin_sys():
    coo, _, csr, _ = ts.umfpack_unsymmetric_5x5(CPU)
    jcoo, _, jcsr, _ = js.umfpack_unsymmetric_5x5()
    x = np.arange(1.0, 6.0)
    rhs = np.array([8.0, 45.0, -3.0, 3.0, 19.0])
    for ours, ref in ((coo, jcoo), (csr, jcsr), (coo.as_dense(),
                                                 jcoo.as_dense())):
        v = VerifyLinSys.from_system(ours, torch.as_tensor(x), rhs)
        w = JVerify.from_system(ref, x, rhs)
        assert (v.max_abs_a, v.max_abs_ax) == (w.max_abs_a, w.max_abs_ax)
        assert v.relative_error == pytest.approx(w.relative_error, abs=1e-14)


# -- MatrixMarket -------------------------------------------------------------


@pytest.mark.parametrize("name,handling", [
    ("umfpack_unsymmetric_5x5", MMsym.LEAVE_AS_LOWER),
    ("mkl_positive_definite_5x5_lower", MMsym.LEAVE_AS_LOWER),
    ("mkl_positive_definite_5x5_lower", MMsym.SWAP_TO_UPPER),
    ("mkl_positive_definite_5x5_lower", MMsym.MAKE_IT_FULL),
    ("complex_symmetric_3x3_lower", MMsym.MAKE_IT_FULL),
    ("complex_rectangular_4x3", MMsym.LEAVE_AS_LOWER)])
def test_matrix_market_round_trip_across_packages(tmp_path, name, handling):
    coo, _, csr, _ = getattr(ts, name)(CPU)
    jcoo = getattr(js, name)()[0]
    jhandling = JMMsym[handling.name]
    for mat, fname in ((coo, "coo.mtx"), (csr, "csr.mtx")):
        p = str(tmp_path / fname)
        write_matrix_market(mat, p)
        jp = str(tmp_path / ("j" + fname))
        j_write(jcoo if mat is coo else JCsr.from_coo(jcoo), jp)
        assert open(p).read() == open(jp).read()
        ours = read_matrix_market(p, handling)
        ref = j_read(p, jhandling)
        for a, b in zip(ours, ref):
            assert (a is None) == (b is None)
            if a is not None:
                _coo_equal(a, b)
    ps = str(tmp_path / "m.smat")
    write_matrix_market(coo, ps)
    j_write(jcoo, str(tmp_path / "j.smat"))
    assert open(ps).read() == open(str(tmp_path / "j.smat")).read()


@pytest.mark.parametrize("text", [
    "", "%%MatrixMarket matrix array real general\n2 2 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate integer general\n2 2 1\n1 1 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1.0\n2 2 1\n",
    "%%MatrixMarket matrix coordinate real symmetric\n2 3 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n2 2 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real symmetric\n2 2 1\n1 2 1.0\n",
    "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n"])
def test_matrix_market_bad_files_raise_as_the_reference(tmp_path, text):
    p = tmp_path / "bad.mtx"
    p.write_text(text)
    with pytest.raises(ValueError) as want:
        j_read(str(p))
    with pytest.raises(ValueError) as got:
        read_matrix_market(str(p))
    assert str(got.value) == str(want.value)


# -- BSR ----------------------------------------------------------------------


def _rect_coo(pkg):
    """A 37 x 300 matrix from a seed (ragged block rows and x panels)."""
    rng = np.random.default_rng(21)
    ii = rng.integers(0, 37, 400)
    jj = rng.integers(0, 300, 400)
    return pkg.from_arrays(37, 300, ii, jj, rng.standard_normal(400))


def _empty_tail_coo(pkg):
    """100 x 100 with rows 40.. empty: the last block rows are all pads."""
    rng = np.random.default_rng(22)
    ii = rng.integers(0, 40, 300)
    jj = rng.integers(0, 100, 300)
    return pkg.from_arrays(100, 100, ii, jj, rng.standard_normal(300))


BSR_CASES = {
    "lap15_8x128": (lambda p: (ts if p is CooMatrix else js).laplacian_2d(15),
                    8, 128),
    "lap10_16x16": (lambda p: (ts if p is CooMatrix else js).laplacian_2d(10),
                    16, 16),
    "rect37x300_8x128": (_rect_coo, 8, 128),
    "irregular500_8x128": (
        lambda p: (ts if p is CooMatrix else js).irregular_geometric(500),
        8, 128),
    "empty_tail_16x16": (_empty_tail_coo, 16, 16),
}


def _bsr_pair(case):
    make, bm, bn = BSR_CASES[case]
    coo, jcoo = make(CooMatrix), make(JCoo)
    return (coo, tk.bsr_from_coo(coo, bm, bn, device=CPU),
            jk.bsr_from_coo(jcoo, bm, bn))


@pytest.mark.parametrize("case", list(BSR_CASES))
def test_bsr_from_coo_and_products_match_reference(case):
    coo, bsr, jbsr = _bsr_pair(case)
    assert (bsr.n_rows, bsr.n_cols, bsr.bm, bsr.bn, bsr.nbr,
            bsr.blocks_per_row) == (jbsr.n_rows, jbsr.n_cols, jbsr.bm,
                                    jbsr.bn, jbsr.nbr, jbsr.blocks_per_row)
    for f in ("blocks", "col_ids", "mask"):
        np.testing.assert_array_equal(getattr(bsr, f).numpy(),
                                      np.asarray(getattr(jbsr, f)))
    assert (bsr.n_rows_pad, bsr.n_cols_pad) == (jbsr.n_rows_pad,
                                                jbsr.n_cols_pad)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(coo.ncol)
    X = rng.standard_normal((coo.ncol, 3))
    n0 = (tk.bsr_matvec.launches, tk.bsr_matmat.launches)
    y = tk.bsr_matvec(bsr, x)
    Y = tk.bsr_matmat(bsr, torch.as_tensor(X))
    assert (tk.bsr_matvec.launches, tk.bsr_matmat.launches) == n0  # plain
    assert y.shape == (coo.nrow,) and Y.shape == (coo.nrow, 3)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jk.bsr_matvec(jbsr, x, use_pallas=True)),
        rtol=0, atol=BSR_ATOL)
    np.testing.assert_allclose(
        Y.numpy(), np.asarray(jk.bsr_matmat(jbsr, X, use_pallas=True)),
        rtol=0, atol=BSR_ATOL)
    A = coo.as_dense()
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=0, atol=BSR_ATOL)


@pytest.mark.parametrize("case", ["lap10_16x16", "empty_tail_16x16"])
def test_spgemm_plan_and_product_match_reference(case):
    coo, bsr, jbsr = _bsr_pair(case)
    plan = tk.spgemm_plan(bsr, bsr)
    jplan = jk.spgemm_plan(jbsr, jbsr)
    for f in ("n", "b", "c_blocks"):
        assert getattr(plan, f) == getattr(jplan, f)
    for f in ("a_idx", "b_idx", "c_idx", "c_block_ij"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    # c_ptr marks where the reference's c_first does
    first = np.zeros(len(plan.c_idx), dtype=np.int32)
    first[plan.c_ptr[:-1][np.diff(plan.c_ptr) > 0]] = 1
    np.testing.assert_array_equal(first, jplan.c_first)
    assert plan.c_ptr[-1] == len(plan.c_idx)
    C, cij = tk.spgemm(plan, bsr, bsr)
    jC, jcij = jk.spgemm(jplan, jbsr, jbsr, use_pallas=True)
    np.testing.assert_array_equal(cij, jcij)
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=0,
                               atol=BSR_ATOL)
    # reassembled against the dense product
    b = bsr.bm
    Cd = np.zeros((bsr.n_rows_pad, bsr.n_rows_pad))
    for q in range(plan.c_blocks):
        i, j = cij[q]
        Cd[i * b:(i + 1) * b, j * b:(j + 1) * b] += C[q].numpy()
    A = coo.as_dense()
    np.testing.assert_allclose(Cd[:coo.nrow, :coo.ncol], A @ A, rtol=0,
                               atol=BSR_ATOL)


def test_interop_round_trips_bsr_and_spgemm_plan():
    _, bsr, jbsr = _bsr_pair("lap10_16x16")
    carried = interop.bsr_from(jbsr, CPU)
    for f in ("blocks", "col_ids", "mask"):
        assert torch.equal(getattr(carried, f), getattr(bsr, f))
    back = jk.BsrMatrix(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v)
                           for k, v in interop.bsr_fields(bsr).items()})
    for f in ("blocks", "col_ids", "mask"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jbsr, f)))
    assert back.blocks_per_row == jbsr.blocks_per_row
    plan = interop.spgemm_plan_from(jk.spgemm_plan(jbsr, jbsr))
    ours = tk.spgemm_plan(bsr, bsr)
    for f in ("a_idx", "b_idx", "c_idx", "c_ptr", "c_block_ij"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(ours, f))
    C1, _ = tk.spgemm(plan, carried, carried)
    C2, _ = tk.spgemm(ours, bsr, bsr)
    assert torch.equal(C1, C2)


def test_bsr_wrappers_raise_on_bad_input():
    coo, bsr, _ = _bsr_pair("lap10_16x16")
    with pytest.raises(ValueError):                      # x too short
        tk.bsr_matvec(bsr, np.ones(coo.ncol - 1))
    with pytest.raises(ValueError):                      # X must be 2-D
        tk.bsr_matmat(bsr, np.ones(coo.ncol))
    _, other, _ = _bsr_pair("lap15_8x128")
    plan = tk.spgemm_plan(bsr, bsr)
    with pytest.raises(ValueError):                      # inner dims
        tk.spgemm(plan, other, bsr)
    small = tk.bsr_from_coo(ts.laplacian_2d(3), 16, 16, device=CPU)
    with pytest.raises(ValueError):                      # plan of others
        tk.spgemm(plan, small, small)
    meta = tk.BsrMatrix(bsr.n_rows, bsr.n_cols, bsr.bm, bsr.bn, bsr.nbr,
                        bsr.blocks_per_row, bsr.blocks.to("meta"),
                        bsr.col_ids.to("meta"), bsr.mask.to("meta"))
    with pytest.raises(ValueError):                      # no kernel, no plain
        tk.bsr_matvec(meta, torch.ones(coo.ncol, device="meta"))
    with pytest.raises(ValueError):                      # col id past x
        tk.bsr_from_arrays(4, 4, 2, 2, np.zeros((2, 2, 2)),
                           np.array([[0], [2]]), np.ones((2, 1)), CPU)
    with pytest.raises(ValueError):                      # triangular
        tk.bsr_from_coo(ts.lower_symmetric_5x5(CPU)[0], device=CPU)


# -- the card by default --------------------------------------------------------


def _ode_solver():
    system, *_ = tode_samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.SPLU
    return OdeSolver(params, system).device


ENTRY_POINTS = {
    "device": lambda: russell_tpu_torch.device(),
    "OdeSolver": _ode_solver,
    "bsr_from_coo": lambda: tk.bsr_from_coo(ts.laplacian_2d(4)).blocks.device,
    "bsr_from": lambda: interop.bsr_from(
        jk.bsr_from_coo(js.laplacian_2d(4))).blocks.device,
    "CsrMatrix.from_coo": lambda: CsrMatrix.from_coo(
        ts.laplacian_2d(4)).data.device,
    "CscMatrix.from_coo": lambda: CscMatrix.from_coo(
        ts.laplacian_2d(4)).data.device,
    "samples": lambda: ts.tiny_1x1()[2].data.device,
    "factor_to_torch": lambda: interop.factor_to_torch(
        {"logdet": np.zeros(1)})["logdet"].device,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Without a device argument every entry point puts its tensors on
    torch.device("cuda"); without a card that raises — no CPU fallback."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[entry]().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[entry]()
