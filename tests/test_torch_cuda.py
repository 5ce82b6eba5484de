"""russell_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the SPLU factorization, Radau5 and the BSR products
on CUDA against the same code on the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax (the GPU machine has none); run it there without the
suite's conftest, which sets jax up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
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


@pytest.mark.parametrize("be", [32, 64])
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


@pytest.mark.parametrize("be", [32, 64])
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
        dp = kernels._device_plan(plan, cuda)
        _assert_kernel_close(C, kernels._spgemm_plain(dp, bsr, bsr,
                                                      plan.c_blocks))
        # and against the CPU run of the same plan
        cpu = kernels.bsr_from_coo(coo, bm, bn, device="cpu")
        C_cpu, _ = kernels.spgemm(plan, cpu, cpu)
        _assert_kernel_close(C.cpu(), C_cpu)


def test_bsr_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    coo = ssamples.laplacian_2d(10)
    x = torch.ones(coo.ncol, dtype=torch.float64, device=cuda)
    wide = kernels.bsr_from_coo(coo, 64, 64, device=cuda)
    with pytest.raises(ValueError):     # bm 64 > 32: no kernel, no fallback
        kernels.bsr_matvec(wide, x)
    odd = kernels.bsr_from_coo(coo, 8, 7, device=cuda)
    with pytest.raises(ValueError):     # odd bn
        kernels.bsr_matvec(odd, x)
    X = torch.ones((coo.ncol, 256), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):     # bm * m > 1024
        kernels.bsr_matmat(kernels.bsr_from_coo(coo, 8, 128, device=cuda), X)
    with pytest.raises(ValueError):     # bm * bn > 1024
        kernels.spgemm(kernels.spgemm_plan(wide, wide), wide, wide)
