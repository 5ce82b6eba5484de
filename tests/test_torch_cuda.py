"""russell_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the SPLU, GRIDMF and DENSE factorizations, the ODE
methods with Output and the BSR products on CUDA against the same code on
the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax (the GPU machine has none); run it there without the
suite's conftest, which sets jax up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples
from russell_tpu_torch.sparse import factor, kernels, splu
from russell_tpu_torch.sparse import samples as ssamples
from russell_tpu_torch.sparse.coo import CooMatrix
from russell_tpu_torch.sparse.enums import Genie

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _brusselator_plan(npoint):
    system, _, y0, _ = samples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    n = system.ndim
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    jv = system.jacobian(0.0, torch.as_tensor(y0), None).numpy()
    return factor.analyze(n, rows, cols, genie=Genie.SPLU), jv


def _row_args(dp, blocks, r, be):
    _, ln, _, npair, *_ = dp["rows"][r]
    return (blocks, dp["pair_l"][r, :npair], dp["pair_u"][r, :npair],
            dp["pair_seg"][r, :npair], dp["work"][r], ln, be)


@pytest.mark.parametrize("be", [16, 32, 64])
def test_kernels_match_plain_versions(cuda, be):
    plan, _ = _brusselator_plan(16)
    sp = plan.splu_plan
    dp = splu._device_plan(sp, cuda)
    TL = sp.packed["TL"]
    rng = np.random.default_rng(be)
    blocks = torch.as_tensor(
        rng.standard_normal((sp.nblk + TL + 1, be * be)), device=cuda)
    blocks[0] = 0.0
    # every row: among them the row with the longest lane and rows whose
    # len is below TL
    seg_ptr = splu._seg_ptr(sp.packed["pair_seg"], TL)
    lens = [row[1] for row in dp["rows"]]
    longest = max(range(len(lens)), key=lambda r: int(
        np.diff(seg_ptr[r, :lens[r] + 1]).max()))
    assert min(lens) < TL and any(row[6] for row in dp["rows"])
    for r in sorted(range(len(lens)), key=lambda r: r != longest):
        args = _row_args(dp, blocks, r, be)
        ln = args[5]
        # live pairs; and the padded row, whose pads must drop out
        for n in (args[1].numel(), dp["pair_l"].shape[1]):
            args = (blocks, dp["pair_l"][r, :n], dp["pair_u"][r, :n],
                    dp["pair_seg"][r, :n], dp["work"][r], ln, be)
            n0 = splu.splu_pairs.launches
            got = splu.splu_pairs(*args)
            assert splu.splu_pairs.launches == n0 + 1
            assert got.shape == (ln, be * be)
            want = splu._splu_pairs_plain(*args[:4], ln, be)
            # the sum order differs (tensor-core tiles and per-chunk
            # partials vs bmm + index_add_)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)
        idx = dp["dinv"][r, :ln]
        n0 = splu.gather_rows.launches
        assert torch.equal(splu.gather_rows(blocks, idx), blocks[idx])
        assert splu.gather_rows.launches == n0 + 1


@pytest.mark.parametrize("be", [16, 32, 64])
def test_splu_pairs_is_bit_identical_across_launches(cuda, be):
    plan, _ = _brusselator_plan(16)
    sp = plan.splu_plan
    dp = splu._device_plan(sp, cuda)
    rng = np.random.default_rng(be + 1)
    blocks = torch.as_tensor(rng.standard_normal(
        (sp.nblk + sp.packed["TL"] + 1, be * be)), device=cuda)
    multi = [r for r, row in enumerate(dp["rows"]) if row[6]]
    assert multi
    for r in range(len(dp["rows"])):
        args = _row_args(dp, blocks, r, be)
        first = splu.splu_pairs(*args)
        for _ in range(3 if r in multi else 1):
            assert torch.equal(splu.splu_pairs(*args), first)
    # the per-lane tickets are left at zero for the next launch
    torch.cuda.synchronize()
    assert splu._tickets and not any(t.any() for t in splu._tickets.values())


@pytest.mark.parametrize("be", [32, 64])
def test_splu_pairs_on_two_streams_is_bit_identical(cuda, be):
    # the multi-chunk lanes' tickets and partials are per stream and per
    # call: launches of one plan on two streams, free to overlap, must not
    # mix them
    plan, _ = _brusselator_plan(16)
    sp = plan.splu_plan
    dp = splu._device_plan(sp, cuda)
    rng = np.random.default_rng(be + 2)
    blocks = torch.as_tensor(rng.standard_normal(
        (sp.nblk + sp.packed["TL"] + 1, be * be)), device=cuda)
    multi = [r for r, row in enumerate(dp["rows"]) if row[6]]
    want = {r: splu.splu_pairs(*_row_args(dp, blocks, r, be)) for r in multi}
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        for r in multi:
            for s in streams:
                with torch.cuda.stream(s):
                    got.append((r, splu.splu_pairs(*_row_args(dp, blocks, r,
                                                              be))))
    torch.cuda.synchronize()
    for r, out in got:
        assert torch.equal(out, want[r])
    assert not any(t.any() for t in splu._tickets.values())


@pytest.mark.parametrize("width", [1024, 4096])
def test_gather_rows_is_exact_at_every_size(cuda, width):
    rng = np.random.default_rng(width)
    blocks = torch.as_tensor(rng.standard_normal((1100, width)),
                             device=cuda)
    for rows in (1, 36, 1024):
        # few distinct sources, as the factorize rows gather
        idx = torch.as_tensor(rng.integers(0, 12, rows) * 91,
                              dtype=torch.int32, device=cuda)
        assert torch.equal(splu.gather_rows(blocks, idx), blocks[idx])
        idx = torch.as_tensor(rng.integers(0, 1100, rows),
                              dtype=torch.int32, device=cuda)
        assert torch.equal(splu.gather_rows(blocks, idx), blocks[idx])


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    blocks = torch.zeros((4, 48 * 48), dtype=torch.float64, device=cuda)
    i32 = torch.zeros(2, dtype=torch.int32, device=cuda)
    chunk = torch.tensor([[0, 0, 1, 1], [1, 1, 1, 1]], dtype=torch.int32,
                         device=cuda)
    work = splu.PairWork(chunk, torch.arange(2, dtype=torch.int32,
                                             device=cuda), 0)
    with pytest.raises(ValueError):     # be 48: no kernel, no fallback
        splu.splu_pairs(blocks, i32, i32, i32, work, 2, 48)
    with pytest.raises(ValueError):     # the work list on another device
        splu.splu_pairs(torch.zeros((4, 32 * 32), dtype=torch.float64,
                                    device=cuda), i32, i32, i32,
                        splu.PairWork(chunk.cpu(), work.lane_off, 0),
                        2, 32)
    with pytest.raises(ValueError):     # odd row width
        splu.gather_rows(torch.zeros((4, 3), dtype=torch.float64,
                                     device=cuda), i32)
    with pytest.raises(ValueError):     # indices on another device
        splu.gather_rows(blocks, i32.cpu())


def test_factorize_pair_on_card_matches_cpu(cuda):
    plan, jv = _brusselator_plan(16)
    n = plan.n
    vr = np.concatenate([-jv, np.full(n, 37.0)])
    vc = np.concatenate([-jv.astype(np.complex128), np.full(n, 27.0 + 31.0j)])
    facs = {}
    for dev in ("cpu", cuda):
        facs[str(dev)] = factor.numeric_factorize_pair(
            plan, torch.as_tensor(vr, device=dev),
            torch.as_tensor(vc, device=dev))
    for fc, fg in zip(facs["cpu"], facs[str(cuda)]):
        for k in ("blocks", "logdet", "min_pivot", "phase", "rs", "cs"):
            torch.testing.assert_close(fg[k].cpu(), fc[k], rtol=1e-12,
                                       atol=1e-13, msg=k)
        assert int(fg["n_perturbed"]) == int(fc["n_perturbed"])
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    x_cpu = factor.factor_solve_pair(plan, *facs["cpu"], b, b + 0j)
    x_gpu = factor.factor_solve_pair(plan, *facs[str(cuda)], b.to(cuda),
                                     (b + 0j).to(cuda))
    for xg, xc in zip(x_gpu, x_cpu):
        torch.testing.assert_close(xg.cpu(), xc, rtol=1e-11, atol=1e-13)


def test_radau5_van_der_pol_on_card(cuda):
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    params.newton.genie = Genie.SPLU
    sol = OdeSolver(params, system, cuda)
    y = sol.solve(y0, x0, x1, args=args)
    st = sol.stats()
    assert y.device.type == "cuda"
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected, st.n_iterations,
            st.n_iterations_max) == (2249, 162, 253, 668, 280, 242, 8, 2, 6)
    assert abs(float(y[0]) - 1.706163410178079E+00) < 1e-12
    assert abs(float(y[1]) - (-8.927971289301175E-01)) < 1e-11


def _random_coo(nrow, ncol, nnz, row_hi, seed):
    rng = np.random.default_rng(seed)
    return CooMatrix.from_arrays(nrow, ncol, rng.integers(0, row_hi, nnz),
                                 rng.integers(0, ncol, nnz),
                                 rng.standard_normal(nnz))


# ragged last block rows and x panels, pads, and (empty_tail) block rows
# made only of pads
BSR_CASES = {
    "lap15_8x128": (lambda: ssamples.laplacian_2d(15), 8, 128),
    "lap10_16x16": (lambda: ssamples.laplacian_2d(10), 16, 16),
    "rect37x300_8x128": (lambda: _random_coo(37, 300, 400, 37, 21), 8, 128),
    "irregular500_8x128": (lambda: ssamples.irregular_geometric(500), 8, 128),
    "irregular500_16x16": (lambda: ssamples.irregular_geometric(500), 16, 16),
    "empty_tail_16x16": (lambda: _random_coo(100, 100, 300, 40, 22), 16, 16),
}


def _assert_kernel_close(got, want):
    # the sum order differs (per-lane FMA loops vs einsum / bmm + index_add_)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("case", list(BSR_CASES))
def test_bsr_kernels_match_plain_versions(cuda, case):
    make, bm, bn = BSR_CASES[case]
    coo = make()
    bsr = kernels.bsr_from_coo(coo, bm, bn, device=cuda)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
    n0 = kernels.bsr_matvec.launches
    y = kernels.bsr_matvec(bsr, x)
    assert kernels.bsr_matvec.launches == n0 + 1
    _assert_kernel_close(y, kernels._bsr_matvec_plain(bsr, x))
    for m in (1, 3, 16):
        X = torch.as_tensor(rng.standard_normal((coo.ncol, m)), device=cuda)
        n0 = kernels.bsr_matmat.launches
        Y = kernels.bsr_matmat(bsr, X)
        assert kernels.bsr_matmat.launches == n0 + 1
        _assert_kernel_close(Y, kernels._bsr_matmat_plain(bsr, X))
    if bm == bn:
        plan = kernels.spgemm_plan(bsr, bsr)
        n0 = kernels.spgemm.launches
        C, cij = kernels.spgemm(plan, bsr, bsr)
        assert kernels.spgemm.launches == n0 + 1
        _assert_kernel_close(C, kernels._spgemm_plain(plan, bsr, bsr))
        # and against the CPU run of the same plan
        cpu = kernels.bsr_from_coo(coo, bm, bn, device="cpu")
        C_cpu, _ = kernels.spgemm(plan, cpu, cpu)
        _assert_kernel_close(C.cpu(), C_cpu)


def test_bsr_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    # the live-entry kernels take every block shape and width m that the
    # reference takes (64x64 and 8x7 blocks, bm * m > 1024 no longer
    # refused; SpGEMM 64x64 and 128x128 blocks, bm * bn > 1024 no longer
    # refused); the wrappers still raise on a wrong x shape, on a matrix
    # whose arrays lie partly on the CPU, and (SpGEMM) on C blocks whose
    # one row exceeds the card's shared memory
    coo = ssamples.laplacian_2d(10)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, 256)), device=cuda)
    for bm, bn in ((64, 64), (8, 7), (8, 128)):
        bsr = kernels.bsr_from_coo(coo, bm, bn, device=cuda)
        n0 = (kernels.bsr_matvec.launches, kernels.bsr_matmat.launches)
        _assert_kernel_close(kernels.bsr_matvec(bsr, x),
                             kernels._bsr_matvec_plain(bsr, x))
        _assert_kernel_close(kernels.bsr_matmat(bsr, X),
                             kernels._bsr_matmat_plain(bsr, X))
        assert (kernels.bsr_matvec.launches,
                kernels.bsr_matmat.launches) == (n0[0] + 1, n0[1] + 1)
    with pytest.raises(ValueError):     # x too short
        kernels.bsr_matvec(bsr, x[:-1])
    with pytest.raises(ValueError):     # X must be 2-D
        kernels.bsr_matmat(bsr, x)
    mixed = kernels.BsrMatrix(bsr.n_rows, bsr.n_cols, bsr.bm, bsr.bn,
                              bsr.nbr, bsr.blocks_per_row, bsr.blocks,
                              bsr.col_ids.cpu(), bsr.mask)
    with pytest.raises(ValueError):     # col ids on the CPU, blocks on the card
        kernels.bsr_matvec(mixed, x)
    with pytest.raises(ValueError):
        kernels.bsr_matmat(mixed, X)
    for b in (64, 128):     # 128: a block past the strip, cut into rows
        wide = kernels.bsr_from_coo(coo, b, b, device=cuda)
        plan = kernels.spgemm_plan(wide, wide)
        _assert_kernel_close(kernels.spgemm(plan, wide, wide)[0],
                             kernels._spgemm_plain(plan, wide, wide))
    a16 = kernels.bsr_from_coo(coo, 16, 16, device=cuda)
    b_wide = kernels.bsr_from_coo(coo, 16, 30000, device=cuda)
    with pytest.raises(ValueError):     # one C block row of 30,000 doubles
        kernels.spgemm(kernels.spgemm_plan(a16, b_wide), a16, b_wide)


def _triplets_coo(nrow, ncol, ii, jj, vv):
    return CooMatrix.from_arrays(nrow, ncol, np.asarray(ii),
                                 np.asarray(jj), np.asarray(vv))


def _long_row_coo():
    lap = ssamples.laplacian_2d(40)
    ii, jj, vv = (np.asarray(a) for a in lap.triplets())
    n = lap.nrow
    return _triplets_coo(n, n, np.concatenate([ii, np.full(n, 77)]),
                         np.concatenate([jj, np.arange(n)]),
                         np.concatenate([vv, np.linspace(-1.0, 1.0, n)]))


def _stored_zeros_coo():
    coo = _random_coo(70, 70, 300, 70, 31)
    ii, jj, vv = (np.asarray(a) for a in coo.triplets())
    return _triplets_coo(70, 70, np.concatenate([ii, ii[:50], [3, 9]]),
                         np.concatenate([jj, jj[:50], [4, 9]]),
                         np.concatenate([vv, -vv[:50], [0.0, 0.0]]))


# the live layout's edge cases: a ragged last slice, empty rows, a matrix
# with no live block, one row much longer than the others (a 1,600-wide
# slice), stored entries that are zero
LAYOUT_CASES = {
    "ragged37x300_8x128": (lambda: _random_coo(37, 300, 400, 37, 21), 8, 128),
    "empty_rows_16x16": (lambda: _random_coo(100, 100, 300, 40, 22), 16, 16),
    "all_empty_8x128": (lambda: _triplets_coo(45, 45, [], [], np.zeros(0)),
                        8, 128),
    "long_row_8x128": (_long_row_coo, 8, 128),
    "stored_zeros_8x16": (_stored_zeros_coo, 8, 16),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_bsr_kernels_on_the_layout_edge_cases(cuda, case):
    make, bm, bn = LAYOUT_CASES[case]
    coo = make()
    bsr = kernels.bsr_from_coo(coo, bm, bn, device=cuda)
    lay = kernels._live_layout(bsr)
    assert lay.val.device.type == "cuda"
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
    y = kernels.bsr_matvec(bsr, x)
    _assert_kernel_close(y, kernels._bsr_matvec_plain(bsr, x))
    _assert_kernel_close(y.cpu(), torch.as_tensor(coo.as_dense()
                                                  @ x.cpu().numpy()))
    for m in (1, 16, 33, 200):
        X = torch.as_tensor(rng.standard_normal((coo.ncol, m)), device=cuda)
        _assert_kernel_close(kernels.bsr_matmat(bsr, X),
                             kernels._bsr_matmat_plain(bsr, X))


def test_bsr_kernels_drop_entries_past_n_rows_and_n_cols(cuda):
    # block row 2 holds rows 8-11 of a 10-row matrix and block column 1
    # columns 8-15 of 13; block row 2 holds block column 1 twice
    rng = np.random.default_rng(11)
    blocks = rng.standard_normal((3 * 2, 4, 8))
    col_ids = np.array([[0, 1], [1, 0], [1, 1]])
    mask = np.array([[1.0, 1.0], [1.0, 0.0], [1.0, 0.5]])
    bsr = kernels.bsr_from_arrays(10, 13, 4, 8, blocks, col_ids, mask, cuda)
    x = torch.as_tensor(rng.standard_normal(13), device=cuda)
    X = torch.as_tensor(rng.standard_normal((13, 5)), device=cuda)
    _assert_kernel_close(kernels.bsr_matvec(bsr, x),
                         kernels._bsr_matvec_plain(bsr, x))
    _assert_kernel_close(kernels.bsr_matmat(bsr, X),
                         kernels._bsr_matmat_plain(bsr, X))


def test_bsr_kernels_are_bit_identical_across_launches(cuda):
    _, jv = _brusselator_plan(16)
    system, *_ = samples.brusselator_pde(2e-3, 16)
    ii, jj = system.jac_structure
    coo = CooMatrix.from_arrays(system.ndim, system.ndim, ii, jj, jv)
    bsr = kernels.bsr_from_coo(coo, 8, 128, device=cuda)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, 16)), device=cuda)
    y, Y = kernels.bsr_matvec(bsr, x), kernels.bsr_matmat(bsr, X)
    for _ in range(3):
        assert torch.equal(kernels.bsr_matvec(bsr, x), y)
        assert torch.equal(kernels.bsr_matmat(bsr, X), Y)
    # an in-place change of the blocks reaches the kernels
    bsr.blocks.mul_(2.0)
    assert torch.equal(kernels.bsr_matvec(bsr, x), 2.0 * y)
    assert torch.equal(kernels.bsr_matmat(bsr, X), 2.0 * Y)


def test_bsr_kernels_under_inference_mode(cuda):
    # tensors made under torch.inference_mode() have no version counter:
    # the wrappers build the layout at each call and see in-place changes
    coo = ssamples.laplacian_2d(12)
    rng = np.random.default_rng(6)
    with torch.inference_mode():
        bsr = kernels.bsr_from_coo(coo, 8, 128, device=cuda)
        x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
        X = torch.as_tensor(rng.standard_normal((coo.ncol, 16)), device=cuda)
        y = kernels.bsr_matvec(bsr, x)
        _assert_kernel_close(y, kernels._bsr_matvec_plain(bsr, x))
        _assert_kernel_close(kernels.bsr_matmat(bsr, X),
                             kernels._bsr_matmat_plain(bsr, X))
        bsr.blocks.mul_(2.0)
        assert torch.equal(kernels.bsr_matvec(bsr, x), 2.0 * y)
    assert "_live_layout" not in bsr.__dict__


def test_bsr_layout_serves_launches_on_other_streams(cuda):
    # the layout is built on one stream and read, then rebuilt, from
    # another: every stream waits on the build it reads
    coo = ssamples.laplacian_2d(40)
    bsr = kernels.bsr_from_coo(coo, 8, 128, device=cuda)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal(coo.ncol), device=cuda)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, 16)), device=cuda)
    want = kernels._bsr_matvec_plain(bsr, x)
    want_X = kernels._bsr_matmat_plain(bsr, X)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        y1 = kernels.bsr_matvec(bsr, x)
    with torch.cuda.stream(s2):
        y2 = kernels.bsr_matvec(bsr, x)
        Y2 = kernels.bsr_matmat(bsr, X)
    torch.cuda.synchronize()
    _assert_kernel_close(y1, want)
    _assert_kernel_close(Y2, want_X)
    assert torch.equal(y1, y2)
    assert bsr.__dict__["_live_layout"]["streams"] == {s1.cuda_stream,
                                                       s2.cuda_stream}
    with torch.cuda.stream(s2):
        bsr.blocks.mul_(2.0)
        y3 = kernels.bsr_matvec(bsr, x)
    s1.wait_stream(s2)
    with torch.cuda.stream(s1):
        Y4 = kernels.bsr_matmat(bsr, X)
    torch.cuda.synchronize()
    assert torch.equal(y3, 2.0 * y1)
    _assert_kernel_close(Y4, 2.0 * want_X)


# SpGEMM over the operands' live entries: matrices from bsr_from_arrays
# with a 0.5 mask, values past n_rows / n_cols and in a mask-0 slot,
# duplicated block columns in A and in B, an empty block row, a plan with
# no products and one that drops A's block columns past B's rows (the same
# cases as tests/test_torch_spgemm_live.py, which also holds them against
# the reference package)
def _edge_a():
    rng = np.random.default_rng(11)
    return (10, 13, 4, 8, rng.standard_normal((3 * 3, 4, 8)),
            np.array([[0, 1, 1], [1, 0, 0], [0, 1, 0]]),
            np.array([[1.0, 0.5, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]))


def _edge_b(live=True):
    rng = np.random.default_rng(12)
    mask = np.array([[1.0, 1.0], [1.0, 0.5]]) if live else np.zeros((2, 2))
    return (13, 11, 8, 4, rng.standard_normal((2 * 2, 8, 4)),
            np.array([[0, 2], [2, 2]]), mask)


def _b_short():
    rng = np.random.default_rng(13)
    return (8, 11, 8, 4, rng.standard_normal((1 * 2, 8, 4)),
            np.array([[0, 2]]), np.array([[1.0, 1.0]]))


def _brusselator_coo(npoint):
    system, t0, y0, _ = samples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    return CooMatrix.from_arrays(system.ndim, system.ndim, ii, jj, jv)


SPGEMM_CASES = {
    "brusselator9_16x16": lambda dev: 2 * (kernels.bsr_from_coo(
        _brusselator_coo(9), 16, 16, device=dev),),
    "lap10_8x8": lambda dev: 2 * (kernels.bsr_from_coo(
        ssamples.laplacian_2d(10), 8, 8, device=dev),),
    # 25 doubles a C block: runs of C that start off 16-byte alignment
    "lap10_5x5": lambda dev: 2 * (kernels.bsr_from_coo(
        ssamples.laplacian_2d(10), 5, 5, device=dev),),
    "lap10_4x16_by_random_16x4": lambda dev: (
        kernels.bsr_from_coo(ssamples.laplacian_2d(10), 4, 16, device=dev),
        kernels.bsr_from_coo(_random_coo(100, 70, 400, 100, 14), 16, 4,
                             device=dev)),
    "edge_arrays": lambda dev: (kernels.bsr_from_arrays(*_edge_a(), dev),
                                kernels.bsr_from_arrays(*_edge_b(), dev)),
    "edge_no_products": lambda dev: (
        kernels.bsr_from_arrays(*_edge_a(), dev),
        kernels.bsr_from_arrays(*_edge_b(False), dev)),
    "edge_a_past_b": lambda dev: (kernels.bsr_from_arrays(*_edge_a(), dev),
                                  kernels.bsr_from_arrays(*_b_short(), dev)),
}


@pytest.mark.parametrize("case", list(SPGEMM_CASES))
def test_spgemm_kernel_on_the_edge_cases(cuda, case, monkeypatch):
    a, b = SPGEMM_CASES[case](cuda)
    plan = kernels.spgemm_plan(a, b)
    n0 = kernels.spgemm.launches
    C, cij = kernels.spgemm(plan, a, b)
    assert kernels.spgemm.launches == n0 + 1
    assert np.array_equal(cij, plan.c_block_ij)
    _assert_kernel_close(C, kernels._spgemm_plain(plan, a, b))
    a_cpu, b_cpu = SPGEMM_CASES[case]("cpu")
    _assert_kernel_close(C.cpu(), kernels.spgemm(plan, a_cpu, b_cpu)[0])
    for _ in range(2):      # two more launches: the same bits
        assert torch.equal(kernels.spgemm(plan, a, b)[0], C)
    # strips cut into chunks of one block, and into runs of two rows of one
    # block: the sum order of every entry is the same, so are the bits
    for budget in (8 * a.bm * b.bn + 4, 2 * (8 * b.bn + 4)):
        monkeypatch.setattr(kernels, "SPGEMM_STRIP_BYTES", budget)
        assert torch.equal(kernels.spgemm(plan, a, b)[0], C)


def test_spgemm_layout_on_other_streams_and_after_an_update(cuda):
    # the RowLayout is built on one stream and read from another; an
    # in-place update of the blocks rebuilds it (A·A: every product 4x)
    a = kernels.bsr_from_coo(_brusselator_coo(17), 16, 16, device=cuda)
    plan = kernels.spgemm_plan(a, a)
    want = kernels._spgemm_plain(plan, a, a)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        C1 = kernels.spgemm(plan, a, a)[0]
    with torch.cuda.stream(s2):
        C2 = kernels.spgemm(plan, a, a)[0]
    torch.cuda.synchronize()
    _assert_kernel_close(C1, want)
    assert torch.equal(C1, C2)
    entry = a.__dict__["_spgemm_layout"]
    assert entry["streams"] == {s1.cuda_stream, s2.cuda_stream}
    assert "_live_layout" not in a.__dict__
    with torch.cuda.stream(s2):
        a.blocks.mul_(2.0)
        C3 = kernels.spgemm(plan, a, a)[0]
    torch.cuda.synchronize()
    assert a.__dict__["_spgemm_layout"] is not entry
    assert torch.equal(C3, 4.0 * C1)


def _gj_inputs(w, m, seed, device):
    """(w, m, m) diagonally dominant blocks, with lanes 0 and w // 2 made
    to meet exact zero pivots: lane 0 at step 0, lane w // 2 at the last
    step (its last diagonal zeroed, the rest of its last row and column
    too, so no update reaches it)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((w, m, m)) + 2.0 * m * np.eye(m)
    D[0, 0, 0] = 0.0
    h = w // 2
    D[h, -1, :] = 0.0
    D[h, :, -1] = 0.0
    return torch.as_tensor(D, device=device)


def _device_kernels(fn):
    """Names of the device kernels (and copies) that ``fn`` runs: every
    event the profiler recorded on the card, whatever its duration (a
    launch short enough to be recorded with 0 device time counts too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("m", [1, 16, 17, 32, 33, 64, 67, 128,
                               splu.GJ_MAX_M])
@pytest.mark.parametrize("w", [1, 64])
def test_gj_inv_matches_plain_version(cuda, m, w):
    D = _gj_inputs(w, m, 10 * m + w, cuda)
    delta = torch.tensor(1e-14, dtype=torch.float64, device=cuda)
    wide = torch.zeros((w, m + 3, m + 3), dtype=torch.float64, device=cuda)
    wide[:, :m, :m] = D
    splu._gj_inv(wide[:, :m, :m], delta)    # the library loads
    n0 = splu._gj_inv.launches
    out = []
    # a view, read in place: one kernel, the statistics its own outputs
    names = _device_kernels(
        lambda: out.append(splu._gj_inv(wide[:, :m, :m], delta)))
    got = out[0]
    assert splu._gj_inv.launches == n0 + 1
    assert len(names) == 1 and "gj_inv" in names[0], names
    want = splu._gj_inv_plain(D, delta)
    # the same elimination, each product and difference rounded as torch
    # rounds them: the same bits
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0)
    for g, p in zip(got[2:], want[2:]):
        assert torch.equal(g, p)
    n_clamped = 1 if w == m == 1 else 2
    assert int(got[3].sum()) == n_clamped
    assert float(got[2].min()) == 0.0


def test_inv_block_on_card_matches_cpu(cuda):
    # 272 = 2 x 136: one Schur split above the base on both devices; the
    # two base calls give the same bits, the split's GEMMs (cuBLAS against
    # the CPU's) round apart
    m = 272
    big = _gj_inputs(64, m, m, cuda)
    delta = torch.tensor(1e-14, dtype=torch.float64, device=cuda)
    n0 = splu._gj_inv.launches
    got = splu._inv_block(big, delta)
    assert splu._gj_inv.launches == n0 + 2
    cpu = splu._inv_block(big.cpu(), delta.cpu())
    torch.testing.assert_close(got[0].cpu(), cpu[0], rtol=1e-11, atol=1e-12)
    torch.testing.assert_close(got[1].cpu(), cpu[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(got[2].cpu(), cpu[2], rtol=1e-12, atol=0)
    assert torch.equal(got[3].cpu(), cpu[3])
    assert torch.equal(got[4].cpu(), cpu[4])


def test_gj_inv_raises_on_what_the_kernel_does_not_take(cuda):
    delta = torch.tensor(1e-14, dtype=torch.float64, device=cuda)
    m = splu.GJ_MAX_M + 1               # above the base: the recursion's
    with pytest.raises(ValueError):
        splu._gj_inv(torch.zeros((2, m, m), dtype=torch.float64,
                                 device=cuda), delta)
    with pytest.raises(TypeError):      # no complex kernel: K embedding
        splu._gj_inv(torch.zeros((2, 4, 4), dtype=torch.complex128,
                                 device=cuda), delta)


def _stencil(nr, nc, s, seed):
    """A full 9-point stencil with all cross-species couplings (the
    reference's test_gridmf._stencil_coo, which needs jax to import)."""
    rng = np.random.default_rng(seed)
    ncell = nr * nc
    m = np.arange(ncell)
    i, j = m % nc, m // nc
    rows, cols = [], []
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            keep = (j + dr >= 0) & (j + dr < nr) & (i + dc >= 0) & (
                i + dc < nc)
            src = m[keep]
            for k in range(s):
                for k2 in range(s):
                    rows.append(k * ncell + src)
                    cols.append(k2 * ncell + src + dr * nc + dc)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return (ncell * s, rows, cols,
            rng.normal(size=len(rows)) + 6.0 * (rows == cols))


@pytest.mark.parametrize("cplx", [False, True])
def test_gridmf_on_card_matches_cpu(cuda, cplx):
    from russell_tpu_torch.sparse import gridmf
    n, rows, cols, vals = _stencil(33, 29, 2, 4)
    rng = np.random.default_rng(5)
    if cplx:
        vals = vals + 0.3j * rng.normal(size=len(vals))
    b = rng.normal(size=n) + (1j * rng.normal(size=n) if cplx else 0.0)
    plan = gridmf.gridmf_analyze(n, rows, cols, (33, 29, 2), leaf_cells=16)
    out = {}
    for dev in ("cpu", cuda):
        n0 = splu._gj_inv.launches
        fac = gridmf.gridmf_factorize(plan, torch.as_tensor(vals,
                                                            device=dev))
        x = gridmf.gridmf_solve(plan, fac, torch.as_tensor(b, device=dev))
        out[str(dev)] = (fac, x, splu._gj_inv.launches - n0)
    (fc, xc, kc), (fg, xg, kg) = out["cpu"], out[str(cuda)]
    assert kc == 0 and kg > 0     # the card's pivot inverses are kernels
    for d, (lc, lg) in enumerate(zip(fc["levels"], fg["levels"])):
        for k, v in lc.items():
            if v is None:
                assert lg[k] is None
                continue
            scale = float(v.abs().max()) if v.numel() else 1.0
            torch.testing.assert_close(lg[k].cpu(), v, rtol=0,
                                       atol=1e-12 * scale,
                                       msg=f"level {d} {k}")
    torch.testing.assert_close(fg["logdet"].cpu(), fc["logdet"],
                               rtol=1e-12, atol=0)
    for k in ("min_pivot", "phase"):
        torch.testing.assert_close(fg[k].cpu(), fc[k], rtol=1e-12, atol=0)
    assert int(fg["n_perturbed"]) == int(fc["n_perturbed"])
    torch.testing.assert_close(xg.cpu(), xc, rtol=1e-12,
                               atol=1e-12 * float(xc.abs().max()))
    A = np.zeros((n, n), vals.dtype)
    np.add.at(A, (rows, cols), vals)
    assert np.abs(A @ xg.cpu().numpy() - b).max() < 1e-10 * np.abs(b).max()


def test_radau5_default_params_run_gridmf_on_card(cuda):
    # the reference's default: no genie set (AUTO), grid hint, n > 1200
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 33)
    params = Params(Method.RADAU5)
    sol = OdeSolver(params, system, cuda)
    assert sol.actual.plan.genie == Genie.GRIDMF
    n0 = splu._gj_inv.launches
    y = sol.solve(y0, t0, 0.1)
    assert y.device.type == "cuda" and bool(torch.isfinite(y).all())
    assert splu._gj_inv.launches > n0
    ref = OdeSolver(params, system, "cpu")
    yc = ref.solve(y0, t0, 0.1)
    keys = ("n_accepted", "n_rejected", "n_factor", "n_lin_sol",
            "n_jacobian")
    assert ({k: getattr(sol.stats(), k) for k in keys}
            == {k: getattr(ref.stats(), k) for k in keys})
    torch.testing.assert_close(y.cpu(), yc, rtol=1e-10, atol=0)


def _complex_coo(coo, seed):
    ii, jj, vv = (np.asarray(a) for a in coo.triplets())
    rng = np.random.default_rng(seed)
    return CooMatrix.from_arrays(coo.nrow, coo.ncol, ii, jj,
                                 vv + 0.3j * rng.standard_normal(len(vv)))


@pytest.mark.parametrize("case", ["lap15_8x128", "irregular500_16x16",
                                  "empty_tail_16x16"])
def test_complex_bsr_kernels_match_plain_versions(cuda, case):
    make, bm, bn = BSR_CASES[case]
    coo = _complex_coo(make(), 3)
    bsr = kernels.bsr_from_coo(coo, bm, bn, device=cuda)
    assert bsr.blocks.dtype == torch.complex128
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(coo.ncol)
                        + 1j * rng.standard_normal(coo.ncol), device=cuda)
    X = torch.as_tensor(rng.standard_normal((coo.ncol, 5))
                        + 1j * rng.standard_normal((coo.ncol, 5)),
                        device=cuda)
    n0 = (kernels.bsr_matvec.launches, kernels.bsr_matmat.launches,
          kernels.spgemm.launches)
    _assert_kernel_close(kernels.bsr_matvec(bsr, x),
                         kernels._bsr_matvec_plain(bsr, x))
    _assert_kernel_close(kernels.bsr_matmat(bsr, X),
                         kernels._bsr_matmat_plain(bsr, X))
    sq = kernels.bsr_from_coo(coo, bm, bm, device=cuda)
    plan = kernels.spgemm_plan(sq, sq)
    C, _ = kernels.spgemm(plan, sq, sq)
    _assert_kernel_close(C, kernels._spgemm_plain(plan, sq, sq))
    assert torch.equal(kernels.spgemm(plan, sq, sq)[0], C)
    assert (kernels.bsr_matvec.launches, kernels.bsr_matmat.launches,
            kernels.spgemm.launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 2)


def test_float32_is_refused_with_the_recorded_message(cuda):
    coo = ssamples.laplacian_2d(6)
    ii, jj, vv = (np.asarray(a) for a in coo.triplets())
    f32 = CooMatrix.from_arrays(coo.nrow, coo.ncol, ii, jj,
                                vv.astype(np.float32))
    bsr = kernels.bsr_from_coo(f32, 8, 8, device=cuda)
    x = torch.ones(coo.ncol, dtype=torch.float32, device=cuda)
    for call in (lambda: kernels.bsr_matvec(bsr, x),
                 lambda: kernels.bsr_matmat(bsr, x[:, None]),
                 lambda: kernels.spgemm(kernels.spgemm_plan(bsr, bsr), bsr,
                                        bsr)):
        with pytest.raises(TypeError, match="refused as intended"):
            call()
    # and complex128's one-row limit of a C block is half float64's
    with pytest.raises(ValueError, match="14527"):
        kernels._strip_chunks(1, 14528, 1, elem=16)
    assert kernels._strip_chunks(1, 14527, 1, elem=16) == (1, 1)


def test_dense_factor_on_card_matches_cpu(cuda):
    # AUTO -> DENSE (n <= dense_threshold), real and complex, on cuSOLVER /
    # MAGMA through torch.linalg: factors' statistics and solves
    system, _, y0, _ = samples.brusselator_pde(2e-3, 6)
    n = system.ndim
    ii, jj = system.jac_structure
    rows = np.concatenate([ii, np.arange(n)])
    cols = np.concatenate([jj, np.arange(n)])
    plan = factor.analyze(n, rows, cols, grid=system.grid)
    assert plan.genie == Genie.DENSE
    jv = system.jacobian(0.0, torch.as_tensor(y0), None)
    vr = torch.cat([-jv, torch.full((n,), 36.0, dtype=torch.float64)])
    vc = torch.cat([-jv + 0j, torch.full((n,), 27.0 + 31.0j)])
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    for vals in (vr, vc):
        fac = factor.numeric_factorize(plan, vals.to(cuda))
        ref = factor.numeric_factorize(plan, vals)
        assert fac["lu"].device.type == "cuda"
        torch.testing.assert_close(fac["piv"].cpu(), ref["piv"], rtol=0,
                                   atol=0)
        for k in ("logdet", "phase", "min_pivot"):
            torch.testing.assert_close(fac[k].cpu(), ref[k], rtol=1e-12,
                                       atol=0)
        x = factor.factor_solve(plan, fac, b.to(cuda))
        torch.testing.assert_close(x.cpu(), factor.factor_solve(plan, ref, b),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["DOPRI5", "DOPRI8", "RADAU5",
                                    "BW_EULER", "RK4"])
def test_ode_methods_with_output_on_card_match_cpu(cuda, method):
    # the npoint-6 Brusselator (AUTO -> DENSE for the implicit methods),
    # dense stations for the DoPri and Radau5 methods, step recording for
    # the others
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 6)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = Params(Method[method])
        out = Output()
        if method in ("DOPRI5", "DOPRI8", "RADAU5"):
            out.set_dense_h_out(0.1).set_dense_recording([0, 40])
        else:
            out.set_step_recording([0, 40])
        sol = OdeSolver(params, system, dev)
        h_equal = 0.05 if method == "BW_EULER" else None
        y = sol.solve(y0, t0, 0.5, h_equal=h_equal, output=out)
        assert y.device.type == dev.type
        runs.append((y.cpu(), sol.stats(), out))
    (y, st, out), (yc, stc, outc) = runs
    for k in ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
              "n_accepted", "n_rejected"):
        assert getattr(st, k) == getattr(stc, k), k
    torch.testing.assert_close(y, yc, rtol=1e-10, atol=0)
    for m in (0, 40):
        np.testing.assert_allclose(out.dense_y(m) or out.step_y(m),
                                   outc.dense_y(m) or outc.step_y(m),
                                   rtol=1e-10)


# -- the fused loops: a step attempt captured as one CUDA graph --------------


def test_when_records_if_nodes_that_the_replay_decides(cuda):
    from russell_tpu_torch.ode._device_loop import DeviceLoop, when
    results = []
    for dev in ("cpu", cuda):
        x = torch.zeros(3, dtype=torch.float64, device=dev)
        tgt = torch.tensor([3.0, 5.0, 8.0], dtype=torch.float64, device=dev)
        cnt = torch.zeros(3, dtype=torch.int64, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)

        def step():
            act = x < tgt

            def body():
                x.add_(torch.where(act, 0.5, 0.0))
                big = act & (x > 4)
                when(big.any(), lambda: cnt.add_(big.long()))

            when(act.any(), body)
            done.copy_(~(x < tgt).any())

        loop = DeviceLoop(step, [x, cnt], done, dev)
        loop.run()
        results.append((x.tolist(), cnt.tolist()))
    assert results[0] == results[1]
    assert loop.if_nodes == 2 and loop.nodes > 0


def test_lane_pow_kernel_is_the_c_library_pow(cuda):
    from russell_tpu_torch.ode._lanes import lane_pow
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.uniform(1e-3, 2.0, 2000),
                        10 ** rng.uniform(-10, 1, 2000)])
    t = torch.as_tensor(v, device=cuda)
    for e in (0.17, 0.04, 0.25, 0.8, 3.0, -0.2):
        got = lane_pow(t, e).cpu().numpy()
        want = np.array([x ** e for x in v])
        # the C library is correctly rounded but for rare near-halfway
        # results, where the two may differ in the last bit
        assert (got != want).sum() <= 10, e
        np.testing.assert_allclose(got, want, rtol=2.3e-16, atol=0)


def test_radau5_fused_matches_fortran_on_card(cuda):
    system, x0, y0, x1, args = samples.van_der_pol(1e-6, False)
    params = Params(Method.RADAU5)
    params.step.h_ini = 1e-6
    sol = OdeSolver(params, system, cuda)
    y = sol.solve(y0, x0, x1, fused=True)
    st = sol.stats()
    assert abs(float(y[0]) - 1.706163410178079E+00) < 1e-12
    assert (st.n_function, st.n_jacobian, st.n_factor, st.n_lin_sol,
            st.n_steps, st.n_accepted, st.n_rejected,
            st.n_iterations_max) == (2249, 162, 253, 668, 280, 242, 8, 6)
    loop = sol._fused[(1, None)].loop
    assert loop.graph is not None and loop.if_nodes > 0


@pytest.mark.parametrize("genie", ["GRIDMF", "SPLU"])
def test_radau5_fused_on_card_matches_host_stepped(cuda, genie):
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie[genie]
    sol = OdeSolver(params, system, cuda)
    yh = sol.solve(y0, t0, 1.0)
    keys = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations_max")
    host = {k: getattr(sol.stats(), k) for k in keys}
    yf = sol.solve(y0, t0, 1.0, fused=True)
    assert {k: getattr(sol.stats(), k) for k in keys} == host
    np.testing.assert_allclose(yf.cpu().numpy(), yh.cpu().numpy(), rtol=0,
                               atol=1e-12)


def test_solve_batch_lanes_on_card_equal_single_solves(cuda):
    system, x0, y0, x1, args = samples.van_der_pol(1e-4, False)
    sol = OdeSolver(Params(Method.RADAU5), system, cuda)
    y0s = np.tile(np.asarray(y0)[None, :], (8, 1))
    y0s[:, 0] += np.linspace(-0.2, 0.2, 8)
    ys, st = sol.solve_batch(y0s, x0, 1.0)
    assert st["status"].tolist() == [1] * 8
    for b in (0, 5):
        y = sol.solve(y0s[b], x0, 1.0, fused=True)
        np.testing.assert_allclose(ys[b].cpu().numpy(), y.cpu().numpy(),
                                   rtol=0, atol=1e-12)
        assert int(st["n_accepted"][b]) == sol.stats().n_accepted


@pytest.mark.parametrize("genie", ["GRIDMF", "SPLU", "GENMF", "BANDED"])
def test_solve_batch_sparse_lanes_on_card_equal_single_solves(cuda, genie):
    # a batched numeric phase over one plan: each lane against its single
    # fused solve
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie[genie]
    sol = OdeSolver(params, system, cuda)
    y0s = np.tile(np.asarray(y0)[None, :], (3, 1))
    y0s[:, 0] += np.linspace(0.0, 2.0, 3)
    y0s[:, -1] *= np.linspace(1.0, 3.0, 3)
    ys, st = sol.solve_batch(y0s, t0, 0.3)
    assert sol.actual.plan.genie == Genie[genie]
    assert st["status"].tolist() == [1] * 3
    assert len(set(st["n_accepted"].tolist())) > 1
    keys = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations_max")
    for b in range(3):
        y = sol.solve(y0s[b], t0, 0.3, fused=True)
        np.testing.assert_allclose(ys[b].cpu().numpy(), y.cpu().numpy(),
                                   rtol=0, atol=1e-12)
        assert {k: int(st[k][b]) for k in keys} == {
            k: getattr(sol.stats(), k) for k in keys}, b


def test_solve_batch_refuses_a_capture_that_does_not_fit(cuda, monkeypatch):
    # the capture would need what the warm-up reserved and the spare; with
    # more spare than the card has, solve_batch refuses before it captures,
    # and the same solver captures and runs once the spare is back
    from russell_tpu_torch.ode import _device_loop
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.GRIDMF
    sol = OdeSolver(params, system, cuda)
    y0s = np.tile(np.asarray(y0)[None, :], (2, 1))
    total = torch.cuda.mem_get_info(cuda)[1]
    monkeypatch.setattr(_device_loop, "CAPTURE_SPARE_BYTES", total)
    with pytest.raises(ValueError, match="not captured.*GiB to spare"):
        sol.solve_batch(y0s, t0, 0.1)
    loop = sol._fused_for(2).loop
    assert loop.graph is None and loop.warmup_bytes > 0
    monkeypatch.undo()
    ys, st = sol.solve_batch(y0s, t0, 0.1)
    assert st["status"].tolist() == [1, 1]
    assert loop.graph is not None


@pytest.mark.parametrize("genie", ["BANDED", "GENMF"])
def test_radau5_fused_banded_genmf_on_card_equal_host_stepped(cuda, genie):
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 16)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie[genie]
    sol = OdeSolver(params, system, cuda)
    yh = sol.solve(y0, t0, 0.5)
    keys = ("n_function", "n_jacobian", "n_factor", "n_lin_sol", "n_steps",
            "n_accepted", "n_rejected", "n_iterations_max")
    host = {k: getattr(sol.stats(), k) for k in keys}
    yf = sol.solve(y0, t0, 0.5, fused=True)
    assert {k: getattr(sol.stats(), k) for k in keys} == host
    assert torch.equal(yf, yh)


@pytest.mark.parametrize("shape", [(40, 40), (1, 136, 136), (3, 1, 40, 40),
                                   (32, 136, 136), (3, 32, 136, 136)])
def test_banded_lu_replays_in_a_conditional_body(cuda, shape):
    # BANDED's LU and solves (bcr.lu_factor, bcr.lu_solve) inside the body
    # of a CUDA graph IF node, as the fused Radau5 runs them: torch's
    # default picks MAGMA's batched LU for more than 16 blocks above 128 x
    # 128 and cuSOLVER's getrs for one matrix and one column, neither of
    # which replays there
    from russell_tpu_torch.ode._device_loop import DeviceLoop, when
    from russell_tpu_torch.sparse import bcr
    g = torch.Generator(device=cuda).manual_seed(3)
    A = torch.randn(shape, generator=g, dtype=torch.float64, device=cuda)
    A = A + shape[-1] * torch.eye(shape[-1], dtype=torch.float64,
                                  device=cuda)
    B = torch.randn(shape[:-1] + (1,), generator=g, dtype=torch.float64,
                    device=cuda)
    out = torch.zeros_like(B)
    done = torch.zeros((), dtype=torch.bool, device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)

    def body():
        lu, piv = bcr.lu_factor(A)
        out.copy_(bcr.lu_solve(lu, bcr.lu_perm(lu, piv), B))

    def step():
        when(pred, body)
        done.fill_(True)

    loop = DeviceLoop(step, [out], done, cuda)
    loop.capture()
    out.zero_()
    loop.graph.replay()
    torch.cuda.synchronize()
    assert loop.if_nodes == 1
    assert float((A @ out - B).abs().max()) <= 1e-12 * shape[-1]


@pytest.mark.parametrize("n,lanes", [(40, 1), (136, 1), (136, 3),
                                     (136, 20)])
def test_dense_route_replays_in_a_conditional_body(cuda, n, lanes):
    # the DENSE route's factorization and solve (factor._dense_*) inside
    # the body of a CUDA graph IF node, as the fused Radau5 runs them: one
    # matrix's solve through cuSOLVER's getrs was refused at the graph's
    # instantiation there; the stored row order's gather and two
    # triangular solves replay, and so does a batch of more than 16
    # matrices above 128 x 128, which torch's default gives MAGMA
    from russell_tpu_torch.ode._device_loop import DeviceLoop, when
    rng = np.random.default_rng(n + lanes)
    rows, cols = np.nonzero(rng.random((n, n)) < 0.2)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    plan = factor.analyze(n, rows, cols, genie=Genie.DENSE)
    vals = rng.standard_normal((lanes, len(rows)))
    vals[:, -n:] += n
    v = torch.as_tensor(vals if lanes > 1 else vals[0], device=cuda)
    b = torch.as_tensor(rng.standard_normal((lanes, n) if lanes > 1 else n),
                        device=cuda)
    out = torch.zeros_like(b)
    done = torch.zeros((), dtype=torch.bool, device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)

    def body():
        fac = factor.numeric_factorize(plan, v)
        out.copy_(factor.factor_solve(plan, fac, b, refine_steps=0))

    def step():
        when(pred, body)
        done.fill_(True)

    loop = DeviceLoop(step, [out], done, cuda)
    loop.capture()
    out.zero_()
    loop.graph.replay()
    torch.cuda.synchronize()
    assert loop.if_nodes == 1
    fac = factor.numeric_factorize(plan, v)
    want = factor.factor_solve(plan, fac, b, refine_steps=0)
    assert torch.equal(out, want)
    a = np.zeros((lanes, n, n))
    np.add.at(a, (slice(None), rows, cols), vals)
    x = out.cpu().numpy().reshape(lanes, n)
    res = np.einsum("lij,lj->li", a, x) - b.cpu().numpy().reshape(lanes, n)
    assert np.abs(res).max() <= 1e-10 * np.abs(a).max()


@pytest.mark.parametrize("be", [32, 64])
def test_splu_kernels_batched_equal_single_lane_launches(cuda, be):
    # lanes (L, N, W) of blocks: one launch, each lane's bits those of a
    # one-lane launch on its blocks
    plan, _ = _brusselator_plan(16)
    sp = plan.splu_plan
    dp = splu._device_plan(sp, cuda)
    L = 4
    rng = np.random.default_rng(be + 7)
    blocks = torch.as_tensor(rng.standard_normal(
        (L, sp.nblk + sp.packed["TL"] + 1, be * be)), device=cuda)
    for r in range(len(dp["rows"])):
        args = _row_args(dp, blocks, r, be)
        ln = args[5]
        n0 = splu.splu_pairs.launches
        got = splu.splu_pairs(*args)
        assert splu.splu_pairs.launches == n0 + 1
        assert got.shape == (L, ln, be * be)
        for lane in range(L):
            one = splu.splu_pairs(blocks[lane], *args[1:])
            assert torch.equal(got[lane], one), (r, lane)
        want = splu._splu_pairs_plain(*args[:4], ln, be)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)
        idx = dp["dinv"][r, :ln]
        n0 = splu.gather_rows.launches
        rows = splu.gather_rows(blocks, idx)
        assert splu.gather_rows.launches == n0 + 1
        assert torch.equal(rows, blocks[:, idx])
    torch.cuda.synchronize()
    assert not any(t.any() for t in splu._tickets.values())


def test_gj_inv_lanes_take_a_delta_per_matrix(cuda):
    # B matrices' pivot blocks in one launch, each with its own threshold:
    # the bits of B one-matrix launches, and each lane's clamps its own
    B, w, m = 4, 16, 40
    D = torch.cat([_gj_inputs(w, m, 70 + b, cuda) for b in range(B)])
    # a pivot only the second matrix's threshold catches
    D[w + 3, 5, :] *= 1e-5
    D[w + 3, :, 5] *= 1e-5
    delta = torch.tensor([1e-14, 1e-6, 1e-14, 1e-12], dtype=torch.float64,
                         device=cuda)
    n0 = splu._gj_inv.launches
    got = splu._gj_inv(D, delta)
    assert splu._gj_inv.launches == n0 + 1
    want = splu._gj_inv_plain(D, delta)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-14, atol=0)
    for g, p in zip(got[2:], want[2:]):
        assert torch.equal(g, p)
    for b in range(B):
        one = splu._gj_inv(D[b * w:(b + 1) * w], delta[b])
        for g, o in zip(got, one):
            assert torch.equal(g[b * w:(b + 1) * w], o), b
    npert = got[3].view(B, w).sum(1).tolist()
    assert npert == [2, 3, 2, 2], npert
    with pytest.raises(ValueError, match="do not split"):
        splu._gj_inv(D[:w + 1], delta)


def test_capture_names_a_system_function_that_reads_the_device(cuda):
    system, x0, y0, args, _ = samples.hairer_wanner_eq1()
    f = system.function

    def reads_host(x, y, a):
        return f(x, y, a) * float(y.abs().max() > -1.0)

    system.function = reads_host
    sol = OdeSolver(Params(Method.DOPRI5), system, cuda)
    with pytest.raises(RuntimeError, match="reads_host"):
        sol.solve(y0, x0, 1.0, fused=True)


def test_dense_complex_lu_captures_in_every_solver(cuda):
    # cuSOLVER's complex LU makes no allocation node in the conditional
    # body once CUBLAS_WORKSPACE_CONFIG is set (russell_tpu_torch does)
    system, t0, y0, _ = samples.brusselator_pde(2e-3, 20)
    params = Params(Method.RADAU5)
    params.newton.genie = Genie.DENSE
    ys = [OdeSolver(params, system, cuda).solve(y0, t0, 0.2, fused=True)
          for _ in range(3)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


# -- LinSolver and its BANDED / GENMF / SPLU routes --------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the CPU runs: torch's CPU build can deadlock
    in batched LAPACK calls run on more than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _irregular(n, seed, cplx):
    ii, jj, vv = ssamples.irregular_geometric(n, seed=seed).triplets()
    if cplx:
        vv = vv + 0.3j * np.random.default_rng(seed).normal(size=len(vv))
    return n, ii, jj, vv


def _factor_on(plan, vals, b, dev):
    fac = factor.numeric_factorize(plan, torch.as_tensor(vals, device=dev))
    x = factor.factor_solve(plan, fac, torch.as_tensor(b, device=dev))
    return fac, x


def _assert_same_solution(fc, xc, fg, xg, plan):
    torch.testing.assert_close(xg.cpu(), xc, rtol=1e-12,
                               atol=1e-12 * float(xc.abs().max()))
    torch.testing.assert_close(fg["logdet"].cpu(), fc["logdet"], rtol=1e-12,
                               atol=0)
    torch.testing.assert_close(fg["min_pivot"].cpu(), fc["min_pivot"],
                               rtol=1e-12, atol=0)
    if "n_perturbed" in fc:
        assert int(fg["n_perturbed"]) == int(fc["n_perturbed"])
    pg, pc = factor.det_phase(plan, fg), factor.det_phase(plan, fc)
    assert abs(pg - pc) < 1e-12


@pytest.mark.parametrize("cplx", [False, True])
def test_genmf_on_card_matches_cpu(cuda, one_thread, cplx):
    n, ii, jj, vv = _irregular(3000, 4, cplx)
    plan = factor.analyze(n, ii, jj, genie=Genie.GENMF)
    assert max(c.e for c in plan.genmf_plan.classes) > splu.GJ_MAX_M
    b = np.sin(np.arange(n)) + (1j * np.cos(np.arange(n)) if cplx else 0.0)
    fc, xc = _factor_on(plan, vv, b, "cpu")
    n0 = splu._gj_inv.launches
    fg, xg = _factor_on(plan, vv, b, cuda)
    assert splu._gj_inv.launches > n0     # the pivot inverses are kernels
    for ci, (a, g) in enumerate(zip(fc["classes"], fg["classes"])):
        for k, v in a.items():
            if v is None:
                assert g[k] is None
                continue
            torch.testing.assert_close(g[k].cpu(), v, rtol=0,
                                       atol=1e-12 * float(v.abs().max()),
                                       msg=f"class {ci} {k}")
    _assert_same_solution(fc, xc, fg, xg, plan)
    # a second factorize-and-solve gives the same bits
    fg2, xg2 = _factor_on(plan, vv, b, cuda)
    assert torch.equal(xg2, xg)
    assert torch.equal(fg2["logdet"], fg["logdet"])
    for a, g in zip(fg["classes"], fg2["classes"]):
        assert all(v is None or torch.equal(v, g[k]) for k, v in a.items())


@pytest.mark.parametrize("kernel,cplx", [("scan", False), ("bcr", False),
                                         ("bcr", True), ("scan", True)])
def test_banded_on_card_matches_cpu(cuda, one_thread, kernel, cplx):
    ii, jj, vv = ssamples.laplacian_2d(40).triplets()
    n = 1600
    if cplx:
        vv = vv + 0.3j * np.random.default_rng(2).normal(size=len(vv))
    plan = factor.analyze(n, ii, jj, genie=Genie.BANDED,
                          banded_kernel=kernel)
    assert plan.nb == 40 and plan.use_bcr == (kernel == "bcr")
    b = np.linspace(1.0, 2.0, n)
    fc, xc = _factor_on(plan, vv, b, "cpu")
    fg, xg = _factor_on(plan, vv, b, cuda)
    _assert_same_solution(fc, xc, fg, xg, plan)
    fg2, xg2 = _factor_on(plan, vv, b, cuda)
    assert torch.equal(xg2, xg)


def test_splu_repeats_are_bit_identical(cuda):
    # the ordered sums of the assembly and the solve: no race on the card
    plan, jv = _brusselator_plan(33)
    n = plan.n
    rng = np.random.default_rng(3)
    vr = np.concatenate([-jv, np.full(n, 37.0)])
    vc = vr + 0.3j * rng.normal(size=len(vr))
    b = rng.normal(size=n)
    for vals in (vr, vc):
        runs = [_factor_on(plan, vals, b, cuda) for _ in range(2)]
        (f1, x1), (f2, x2) = runs
        assert torch.equal(f1["blocks"], f2["blocks"])
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("cplx", [False, True])
def test_segment_sum_on_card_repeats_and_matches_cpu(cuda, cplx):
    from russell_tpu_torch.sparse.ordering import segment_index
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 300, 20_000)
    vals = torch.as_tensor(rng.standard_normal((20_000, 8)))
    if cplx:
        vals = torch.complex(vals, torch.as_tensor(
            rng.standard_normal((20_000, 8))))
    order, offsets = (torch.as_tensor(a) for a in segment_index(keys, 310))
    want = splu.segment_sum(vals, order, offsets)
    got = [splu.segment_sum(vals.to(cuda), order.to(cuda), offsets.to(cuda))
           for _ in range(3)]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    torch.testing.assert_close(got[0].cpu(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("genie,kw", [
    ("auto", {"dense_threshold": 100, "max_block": 8}),
    ("banded", {}), ("splu", {"compute_error_estimates": True}),
    ("dense", {})])
def test_lin_solver_on_card_matches_cpu(cuda, one_thread, genie, kw):
    from russell_tpu_torch.sparse import LinSolParams, LinSolver
    coo = ssamples.irregular_geometric(800, seed=5)
    if genie in ("banded", "dense"):
        coo = ssamples.laplacian_2d(20)
    rhs = np.cos(np.arange(coo.nrow))
    out = {}
    for dev in ("cpu", "cuda"):
        s = LinSolver(Genie(genie), device=dev)
        s.factorize(coo, LinSolParams(compute_determinant=True, **kw))
        out[dev] = (s, s.solve(rhs).cpu())
    (sc, xc), (sg, xg) = out["cpu"], out["cuda"]
    assert sg.plan.genie == sc.plan.genie
    if genie == "auto":
        assert sg.plan.genie == Genie.GENMF
    torch.testing.assert_close(xg, xc, rtol=1e-12,
                               atol=1e-12 * float(xc.abs().max()))
    mc, _, ec = sc.determinant()
    mg, _, eg = sg.determinant()
    assert ec == eg and abs(mg - mc) <= 1e-11 * abs(mc)
    assert sg.stats.main["blas_lib"] == "cuBLAS/cuSOLVER"


# -- pde and nonlin on the card ----------------------------------------------

@pytest.mark.parametrize("genie", ["AUTO", "SPLU"])
def test_fdm_2d_on_card_matches_cpu(cuda, one_thread, genie):
    # Poisson at 65 x 65 (3,969 unknowns): AUTO takes GRIDMF with the grid
    # hint (gj_inv on the card); SPLU runs splu_pairs, gather_rows, gj_inv
    from russell_tpu_torch.pde import Fdm2d, Grid2d, problem_samples
    (xmin, xmax, ymin, ymax, kx, ky, ebcs, nbcs, src, _ana, _flow) = \
        problem_samples.d2_problem_01(True)
    grid = Grid2d.new_uniform(xmin, xmax, ymin, ymax, 65, 65)
    out = {}
    for dev in ("cpu", "cuda"):
        fdm = Fdm2d(grid, ebcs, nbcs, kx, ky, device=dev)
        fdm.set_solver_options(Genie[genie])
        splu.reset_launch_counts()
        out[dev] = (fdm.solve_sps(0.0, src), splu._gj_inv.launches,
                    splu.splu_pairs.launches)
    (xc, _, _), (xg, gj, pairs) = out["cpu"], out["cuda"]
    assert gj > 0
    assert (pairs > 0) == (genie == "SPLU")
    err = float(np.abs(xg - xc).max() / np.abs(xc).max())
    assert err <= 1e-10, err


def test_bratu_2d_arclength_on_card_matches_cpu(cuda, one_thread):
    # npoint 17 (ndim 225, AUTO -> DENSE): the eight counters equal to the
    # CPU run's, the steps' lambda at 1e-9; a second card run gives the
    # same bits
    from russell_tpu_torch import nonlin
    runs = []
    for dev in ("cpu", "cuda", "cuda"):
        system, u0, l0, mid = nonlin.samples.bratu_2d_fdm(17)
        solver = nonlin.Solver(nonlin.Config(method=nonlin.Method.ARCLENGTH),
                               system, device=dev)
        out = nonlin.Output().set_recording([mid])
        u, l, status = solver.solve(u0, l0, nonlin.IniDir.POS,
                                    nonlin.Stop.max_comp_u(mid, 6.0),
                                    nonlin.DeltaLambda.auto(0.5), output=out)
        assert status.success()
        st = solver.stats()
        runs.append((u, np.asarray(out.step_l),
                     [st.n_steps, st.n_accepted, st.n_rejected, st.n_function,
                      st.n_jacobian, st.n_factor, st.n_lin_sol,
                      st.n_iteration_total]))
    (uc, lc, cc), (ug, lg, cg), (ug2, lg2, cg2) = runs
    assert cg == cc and cg2 == cc
    np.testing.assert_allclose(lg, lc, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ug, uc, rtol=1e-9, atol=1e-9)
    assert np.array_equal(ug2, ug) and np.array_equal(lg2, lg)


@pytest.mark.parametrize("n,route,ctas", [(2, "cta", 16), (6, "cta", 16),
                                          (33, "cta", 16),
                                          (33, "cluster", 16),
                                          (130, "cluster", 16),
                                          (130, "cluster", 8),
                                          (33, "global", 16)])
def test_jacobi_eig_kernel_matches_plain_version(cuda, n, route, ctas):
    """jacobi_eig against its plain version, bit for bit, one launch, on
    each route: n 2 (equal diagonal: the 45-degree rotation), 6 and 33 in
    one CTA; 33 on a cluster with JACOBI_SMEM_BYTES lowered to 4 KB, and
    130, the first n past one CTA's budget, on 16 CTAs and on 8 (the
    portable size, which a card that schedules no 16 gets); 33 on the
    cluster's global scratch with the budget lowered to 1 KB. Then
    mat_eigen_sym_jacobi on the same route within 1e-12 max|A| of numpy's
    eigenvalues."""
    from russell_tpu_torch.dense import matrix_ops
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    if n == 2:
        a = np.array([[2.0, 1.0], [1.0, 2.0]])
    saved = matrix_ops.JACOBI_SMEM_BYTES, matrix_ops.JACOBI_CLUSTER
    try:
        matrix_ops.JACOBI_CLUSTER = ctas
        if route == "cluster" and n < 119:
            matrix_ops.JACOBI_SMEM_BYTES = 4096
        if route == "global":
            matrix_ops.JACOBI_SMEM_BYTES = 1024
        got = matrix_ops._jacobi_route(n)
        assert got[0] == route
        assert got[1] == (1 if route == "cta" else ctas)
        n0 = matrix_ops.jacobi_eig.launches
        w, V = matrix_ops.jacobi_eig(torch.as_tensor(a, device=cuda))
        torch.cuda.synchronize()
        assert matrix_ops.jacobi_eig.launches == n0 + 1
        ws, Vs = matrix_ops.mat_eigen_sym_jacobi(
            torch.as_tensor(a, device=cuda))
        torch.cuda.synchronize()
    finally:
        matrix_ops.JACOBI_SMEM_BYTES, matrix_ops.JACOBI_CLUSTER = saved
    wp, Vp = matrix_ops._jacobi_eig_plain(torch.as_tensor(a), 30)
    assert torch.equal(w.cpu(), wp) and torch.equal(V.cpu(), Vp)
    assert ws.device.type == "cuda"
    np.testing.assert_allclose(ws.cpu().numpy(), np.linalg.eigvalsh(a),
                               atol=1e-12 * np.abs(a).max())


def test_non_tensor_inputs_land_on_the_card(cuda):
    """A float or a list given to a function of the slice computes on the
    card (the default device)."""
    from russell_tpu_torch.core import linspace
    from russell_tpu_torch.math import chebyshev_tn, gamma
    assert gamma(4.5).device.type == "cuda"
    assert abs(float(gamma(4.5)) - 11.631728396567448) < 1e-13
    assert linspace(0.0, 1.0, 5).device.type == "cuda"
    assert chebyshev_tn(3, 0.5).device.type == "cuda"
    assert chebyshev_tn(3, [0.5, 0.25]).device.type == "cuda"
    assert gamma(4.5, device="cpu").device.type == "cpu"


def test_mat_eigen_batched_on_card(cuda):
    """mat_eigen of a batched CUDA tensor returns four real CUDA planes,
    held by |A V - V diag(l)|."""
    from russell_tpu_torch.dense import mat_eigen
    a = np.array([[0.0, 1.0], [-2.0, -3.0]])
    rot = np.array([[0.0, -1.0], [1.0, 0.0]])
    batch = torch.as_tensor(np.stack([a, a.T, rot]), device=cuda)
    planes = mat_eigen(batch)
    assert all(t.device.type == "cuda" and not t.is_complex() for t in planes)
    lr, li, vr, vi = (t.cpu().numpy() for t in planes)
    lam, V = lr + 1j * li, vr + 1j * vi
    A = batch.cpu().numpy()
    assert np.abs(A @ V - V * lam[:, None, :]).max() < 1e-12
    np.testing.assert_allclose(np.sort(lr[0]), [-2.0, -1.0], atol=1e-12)


def test_newton_solver_on_card_matches_cpu(cuda):
    """NewtonSolver on A u + u^3 - b (A SPD, n 64): the card's Stats
    counters equal the CPU run's, u within 1e-12."""
    from russell_tpu_torch.algo import NewtonSolver
    rng = np.random.default_rng(64)
    n = 64
    g = rng.standard_normal((n, n))
    a = g @ g.T / n + np.eye(n)
    b = rng.standard_normal(n)

    def run(dev):
        A, B = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        solver = NewtonSolver(n)
        u = solver.solve(np.zeros(n), lambda x, u, _: A @ u + u ** 3 - B,
                         device=dev)
        st = solver.stats
        return u, (st.n_function, st.n_jacobian, st.n_iterations)

    u_gpu, c_gpu = run(cuda)
    u_cpu, c_cpu = run("cpu")
    assert u_gpu.device.type == "cuda"
    assert c_gpu == c_cpu
    np.testing.assert_allclose(u_gpu.cpu().numpy(), u_cpu.numpy(),
                               rtol=0, atol=1e-12)


def test_sampling_on_card_repeats_from_a_seed(cuda):
    """The same seed on the card twice gives the same draws, on the card,
    within their distribution's range."""
    from russell_tpu_torch.stat import (DistributionFrechet,
                                        DistributionGumbel,
                                        DistributionLognormal,
                                        DistributionNormal,
                                        DistributionUniform)
    for d in (DistributionFrechet(8.782275, 1.0, 6.0),
              DistributionGumbel(1.0, 2.0), DistributionLognormal(0.5, 0.25),
              DistributionNormal(2.0, 3.0), DistributionUniform(1.0, 3.0)):
        g = torch.Generator("cuda")
        g.manual_seed(5)
        a = d.sample(g, 1 << 16)
        g.manual_seed(5)
        b = d.sample(g, 1 << 16)
        assert a.device.type == "cuda" and a.dtype == torch.float64
        assert torch.equal(a, b) and torch.isfinite(a).all()
        se = (d.variance() / a.numel()) ** 0.5
        assert abs(float(a.mean()) - d.mean()) < 6 * se


def test_vmapped_calc_stress_on_card_matches_cpu(cuda):
    """LinElasticity.calc_stress under torch.func.vmap on the card equals
    the CPU's at rtol 1e-13."""
    from russell_tpu_torch.tensor import LinElasticity, Mandel, Tensor2
    eps = np.random.default_rng(9).standard_normal((4096, 6)) * 1e-3

    def stress(dev):
        le = LinElasticity(210e3, 0.3, device=dev)
        return torch.func.vmap(lambda x: le.calc_stress(
            Tensor2(Mandel.SYMMETRIC, x)).vec)(torch.as_tensor(eps,
                                                               device=dev))

    got = stress(cuda)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), stress("cpu").numpy(),
                               rtol=1e-13, atol=0)


def test_world_of_one_on_nccl_is_single_device_bit_for_bit(cuda, tmp_path):
    # russell_tpu_torch.parallel in a world of one rank on the card: the
    # split SPLU scan (its rank's pair schedule, an all-reduce a row) and
    # the split GRIDMF depths give the single-device factors bit for bit
    import torch.distributed as dist
    from russell_tpu_torch import parallel as par
    from russell_tpu_torch.sparse import gridmf
    plan, jv = _brusselator_plan(17)
    n = plan.n
    vals = torch.as_tensor(np.concatenate([-jv, np.full(n, 30.0)]),
                           device=cuda)
    gplan = factor.analyze(n, plan.rows, plan.cols,
                           grid=samples.brusselator_pde(2e-3, 17)[0].grid,
                           genie=Genie.GRIDMF).gridmf_plan
    par.initialize_multihost(init_method=f"file://{tmp_path}/store",
                             num_processes=1, process_id=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = par.make_mesh()
        sp = plan.splu_plan
        want = splu.splu_factorize(sp, vals)
        n0 = splu.splu_pairs.launches
        got = par.dist_splu_factorize(mesh, sp, vals)
        assert splu.splu_pairs.launches > n0
        for k in ("blocks", "logdet", "min_pivot", "n_perturbed", "phase"):
            assert torch.equal(got[k], want[k]), k
        want = gridmf.gridmf_factorize(gplan, vals)
        got = par.dist_gridmf_factorize(mesh, gplan, vals)
        for d, (g, w) in enumerate(zip(got["levels"], want["levels"])):
            for k, v in w.items():
                assert (v is None and g[k] is None) or torch.equal(g[k], v), \
                    (d, k)
        for k in ("logdet", "min_pivot", "n_perturbed", "phase"):
            assert torch.equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunk_gb", [2.0, 0.1])
def test_gridmf_out_of_core_on_card(cuda, monkeypatch, chunk_gb):
    # laplacian_3d(24) with the hint (24, 24, 24): 0.63 GiB of factors, the
    # leaf depth's 4 fronts 0.17 GiB each (chunk_gb 0.1: a node a chunk)
    from russell_tpu_torch.sparse import gridmf
    coo = ssamples.laplacian_3d(24)
    ii, jj, vv = map(np.asarray, coo.triplets())
    n = coo.nrow
    vals = torch.as_tensor(vv, device=cuda)
    b = torch.as_tensor(np.sin(np.arange(n)), device=cuda)
    monkeypatch.setattr(gridmf, "GRIDMF_CHUNK_GB", chunk_gb)
    runs = {}
    for budget in (factor.GRIDMF_BUDGET_GB, 1e-9):
        monkeypatch.setattr(factor, "GRIDMF_BUDGET_GB", budget)
        plan = factor.analyze(n, ii, jj, genie=Genie.GRIDMF,
                              grid=(24, 24, 24))
        assert plan.gridmf_ooc is (budget == 1e-9)
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fac = factor.numeric_factorize(plan, vals)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            out.append((fac, factor.factor_solve(plan, fac, b), peak))
        runs[plan.gridmf_ooc] = out
    (fi, xi, pi), _ = runs[False]
    (fo, xo, po), (fo2, xo2, _) = runs[True]
    levels = fo["levels"]
    assert isinstance(levels, gridmf.HostLevels)
    nbytes = 0
    for st in levels:
        for k in ("sir", "lr", "br"):
            t = st[k]
            assert t.device.type == "cpu"
            if t.numel():
                assert t.is_pinned(), k
            nbytes += t.numel() * t.element_size()
    # the stores' bytes, each chunk's range rounded up to a page
    assert nbytes <= levels.pinned_bytes < nbytes + 4096 * 3 * 64
    torch.testing.assert_close(xo, xi, rtol=0,
                               atol=1e-12 * float(xi.abs().max()))
    if chunk_gb < 1.0:
        assert po < pi
    # a repeat gives the same bits
    for a, c in zip(levels, fo2["levels"]):
        for k in ("sir", "lr", "br"):
            assert torch.equal(a[k], c[k]), k
    assert torch.equal(xo, xo2)
    for k in ("logdet", "min_pivot", "n_perturbed", "phase"):
        assert torch.equal(fo[k], fo2[k]), k
