"""The clamped Gauss-Jordan pivot inverse of russell_tpu_torch against
russell_tpu's (the reference), on the CPU.

``_gj_inv_plain`` is the plain version the ``gj_inv`` CUDA kernel is held
to on the card (tests/test_torch_cuda.py, chip_smoke.py); both sum the
per-lane statistics step by step in the reference's order. The port's
``_inv_block`` splits only blocks above ``splu.GJ_MAX_M``, the reference's
above 32, so above 32 the two compute the same inverse by other roundings.
The same seeded numpy inputs go through both packages in f64.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from russell_tpu.sparse import splu as jsplu
from russell_tpu_torch.sparse import splu as tsplu

torch.set_num_threads(2)

DELTA = 1e-12


def _blocks(w, m, seed):
    """(w, m, m) diagonally dominant blocks; lane 0 meets an exact zero
    pivot at step 0, lane w // 2 at its last step (its last row and column
    zero, so no update reaches it)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((w, m, m)) + 2.0 * m * np.eye(m)
    D[0, 0, 0] = 0.0
    D[w // 2, -1, :] = 0.0
    D[w // 2, :, -1] = 0.0
    return D


def _both(fn_ref, fn_port, D):
    want = fn_ref(jnp.asarray(D), jnp.asarray(DELTA))
    got = fn_port(torch.as_tensor(D), torch.tensor(DELTA,
                                                   dtype=torch.float64))
    return ([t.numpy() for t in got], [np.asarray(t) for t in want])


@pytest.mark.parametrize("m", [1, 17, 32])
def test_gj_inv_plain_matches_reference(m):
    g, w = _both(jsplu._gj_inv, tsplu._gj_inv_plain, _blocks(4, m, m))
    # the same elimination in the same order, each product and difference
    # rounded apart: the same values
    np.testing.assert_array_equal(g[0], w[0])              # Dinv
    np.testing.assert_array_equal(g[2], w[2])              # min|pivot|
    np.testing.assert_array_equal(g[3], w[3])              # n_perturbed
    np.testing.assert_array_equal(g[4], w[4])              # sign
    # log|det| summed in step order by both; log itself may round apart
    np.testing.assert_allclose(g[1], w[1], rtol=1e-14, atol=0)
    # the zero pivots were clamped: lane 0 at step 0, lane 2 at the last
    assert list(g[3]) == [1, 0, 1, 0]
    assert g[2][0] == 0.0 and g[2][2] == 0.0


@pytest.mark.parametrize("m", [40, 68, 136, 272])
def test_inv_block_matches_reference(m):
    # the port inverts up to GJ_MAX_M in one elimination (272: one Schur
    # split into two of 136), the reference splits down to 32
    assert tsplu.GJ_MAX_M >= 136
    g, w = _both(jsplu._inv_block, tsplu._inv_block, _blocks(4, m, m))
    np.testing.assert_array_equal(g[3], w[3])              # n_perturbed
    assert list(g[3]) == [1, 0, 1, 0]
    assert g[2][0] == w[2][0] == 0.0 and g[2][2] == w[2][2] == 0.0
    live = [1, 3]    # the lanes that clamp nothing: well conditioned
    for k, name in ((1, "log|det|"), (2, "min|pivot|")):
        np.testing.assert_allclose(g[k][live], w[k][live], rtol=1e-12,
                                   atol=0, err_msg=name)
    # off-diagonal entries of Dinv that cancel down to ~1e-9 of the
    # diagonal carry the diagonal's rounding: atol 1e-12 of the lane's max
    for lane in live:
        np.testing.assert_allclose(g[0][lane], w[0][lane], rtol=1e-12,
                                   atol=1e-12 * np.abs(w[0][lane]).max(),
                                   err_msg="Dinv")
    np.testing.assert_array_equal(g[4], w[4])              # sign


def test_gj_inv_plain_is_the_inverse_above_32():
    # what the port's base now covers alone: a (3, GJ_MAX_M) batch, each
    # lane's inverse held to numpy's
    m = tsplu.GJ_MAX_M
    rng = np.random.default_rng(3)
    D = rng.standard_normal((3, m, m)) + 2.0 * m * np.eye(m)
    Dinv, ld, mp, npert, ph = tsplu._gj_inv_plain(
        torch.as_tensor(D), torch.tensor(DELTA, dtype=torch.float64))
    np.testing.assert_allclose(Dinv.numpy(), np.linalg.inv(D), rtol=1e-12,
                               atol=1e-15)
    sign, logdet = np.linalg.slogdet(D)
    np.testing.assert_allclose(ld.numpy(), logdet, rtol=1e-13)
    np.testing.assert_array_equal(ph.numpy(), sign)
    assert npert.tolist() == [0, 0, 0]
    assert (mp.numpy() > m).all()
