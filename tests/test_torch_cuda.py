"""russell_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, and the SPLU factorization and Radau5 on CUDA against
the same code on the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax (the GPU machine has none); run it there without the
suite's conftest, which sets jax up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from russell_tpu_torch.ode import Method, OdeSolver, Params, samples
from russell_tpu_torch.sparse import factor, splu
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
    for r, (_, ln, _, npair, _) in enumerate(dp["rows"]):
        for n in (npair, dp["pair_l"].shape[1]):   # live pairs; padded row
            args = (blocks, dp["pair_l"][r, :n], dp["pair_u"][r, :n],
                    dp["pair_seg"][r, :n], dp["seg_ptr"][r], be)
            n0 = splu.splu_pairs.launches
            got = splu.splu_pairs(*args)
            assert splu.splu_pairs.launches == n0 + 1
            want = splu._splu_pairs_plain(*args[:4], TL, be)
            # the sum order differs (FMA loop vs bmm + index_add_)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)
        idx = dp["dinv"][r, :ln]
        n0 = splu.gather_rows.launches
        assert torch.equal(splu.gather_rows(blocks, idx), blocks[idx])
        assert splu.gather_rows.launches == n0 + 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    blocks = torch.zeros((4, 48 * 48), dtype=torch.float64, device=cuda)
    i32 = torch.zeros(2, dtype=torch.int32, device=cuda)
    sp = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):     # be 48: no kernel, no fallback
        splu.splu_pairs(blocks, i32, i32, i32, sp, 48)
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
