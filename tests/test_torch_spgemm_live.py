"""SpGEMM over the operands' live entries, on the CPU: the RowLayout each
matrix gives the kernel, the device plan's C block-row pointer, and a
sequential walk of those arrays in the order of ``csrc/spgemm_blocks.cu``
(strips of C cut into chunks of whole blocks or of rows), held against
the plain version and against the reference package's interpret-mode
Pallas SpGEMM on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from russell_tpu.sparse import kernels as jk
from russell_tpu_torch.ode import samples as tode_samples
from russell_tpu_torch.sparse import kernels as tk
from russell_tpu_torch.sparse import samples as ts
from russell_tpu_torch.sparse.coo import CooMatrix

CPU = "cpu"
BSR_ATOL = 1e-11        # as tests/test_torch_sparse_formats.py
RTOL = 1e-12            # walk against the plain version: sum orders differ


def _brusselator(npoint):
    system, t0, y0, _ = tode_samples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    return system.ndim, system.ndim, np.asarray(ii), np.asarray(jj), jv


def _triplets(coo):
    return (coo.nrow, coo.ncol, *(np.asarray(a) for a in coo.triplets()))


def _random(nrow, ncol, nnz, seed):
    rng = np.random.default_rng(seed)
    return (nrow, ncol, rng.integers(0, nrow, nnz), rng.integers(0, ncol, nnz),
            rng.standard_normal(nnz))


def _coo_arrays(t, bm, bn):
    """The BSR arrays of triplets ``t`` (through the port's bsr_from_coo)."""
    b = tk.bsr_from_coo(CooMatrix.from_arrays(*t), bm, bn, device=CPU)
    return (b.n_rows, b.n_cols, bm, bn, b.blocks.numpy(), b.col_ids.numpy(),
            b.mask.numpy())


def _edge_a(seed=11):
    """10 x 13 in 4 x 8 blocks, every stored entry set (values past n_rows
    and n_cols too): block row 0 holds block column 1 twice, once at mask
    0.5; block row 1 a mask-0 slot holding values; block row 2 no live
    slot."""
    rng = np.random.default_rng(seed)
    return (10, 13, 4, 8, rng.standard_normal((3 * 3, 4, 8)),
            np.array([[0, 1, 1], [1, 0, 0], [0, 1, 0]]),
            np.array([[1.0, 0.5, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]))


def _edge_b(seed=12, live=True):
    """13 x 11 in 8 x 4 blocks, every stored entry set: block row 1 holds
    block column 2 twice (its B rows hold columns 8-11 twice), once at
    mask 0.5; with ``live`` False no slot is live (a plan with no
    products)."""
    rng = np.random.default_rng(seed)
    mask = np.array([[1.0, 1.0], [1.0, 0.5]]) if live else np.zeros((2, 2))
    return (13, 11, 8, 4, rng.standard_normal((2 * 2, 8, 4)),
            np.array([[0, 2], [2, 2]]), mask)


def _b_short(seed=13):
    """8 x 11 in 8 x 4 blocks: one block row, so A's block column 1 lies
    past B's rows and the plan drops it."""
    rng = np.random.default_rng(seed)
    return (8, 11, 8, 4, rng.standard_normal((1 * 2, 8, 4)),
            np.array([[0, 2]]), np.array([[1.0, 1.0]]))


# (A arrays, B arrays or None for A·A)
CASES = {
    "brusselator9_16x16": (lambda: _coo_arrays(_brusselator(9), 16, 16),
                           None),
    "lap10_8x8": (lambda: _coo_arrays(_triplets(ts.laplacian_2d(10)), 8, 8),
                  None),
    "lap10_4x16_by_random_16x4": (
        lambda: _coo_arrays(_triplets(ts.laplacian_2d(10)), 4, 16),
        lambda: _coo_arrays(_random(100, 70, 400, 14), 16, 4)),
    "edge_arrays": (_edge_a, _edge_b),
    "edge_no_products": (_edge_a, lambda: _edge_b(live=False)),
    "edge_a_past_b": (_edge_a, _b_short),
}


def _pair(case):
    """The case's operands in both packages, and the port's plan."""
    make_a, make_b = CASES[case]
    arrays = [make_a()] + ([make_b()] if make_b else [])
    t = [tk.bsr_from_arrays(*x, device=CPU) for x in arrays]
    j = [jk.BsrMatrix(n, m, bm, bn, -(-n // bm), c.shape[1],
                      jnp.asarray(blk), jnp.asarray(c, jnp.int32),
                      jnp.asarray(mk))
         for n, m, bm, bn, blk, c, mk in arrays]
    return t[0], t[-1], j[0], j[-1], tk.spgemm_plan(t[0], t[-1])


def _dense_terms(bsr):
    """The unscaled stored blocks of the slots with mask > 0, laid out
    densely over every padded row and block column."""
    nbc = int(bsr.col_ids.max()) + 1
    d = np.zeros((bsr.nbr, bsr.bm, nbc, bsr.bn))
    blocks = bsr.blocks.numpy()
    for slot, (c, w) in enumerate(zip(bsr.col_ids.reshape(-1).tolist(),
                                      bsr.mask.reshape(-1).tolist())):
        if w > 0:
            d[slot // bsr.blocks_per_row, :, c] += blocks[slot]
    return d.reshape(bsr.nbr * bsr.bm, nbc * bsr.bn)


def _walk(ra, rb, dp, bm, bn, c_blocks, budget):
    """C as ``spgemm_blocks`` sums it: per C block row, per chunk of its C
    blocks (or rows of one block), each row's A entries in order and, for
    each, B's row k in order, ``strip += a * b`` (a product then a sum, no
    fused multiply-add), entries outside the chunk skipped."""
    a_ptr, a_col, a_val = (t.numpy() for t in (ra.row_ptr, ra.col, ra.val))
    b_ptr, b_col, b_val = (t.numpy() for t in (rb.row_ptr, rb.col, rb.val))
    c_row_ptr, c_col = dp["c_row_ptr"].numpy(), dp["c_col"].numpy()
    rows, blocks = tk._strip_chunks(bm, bn, dp["max_row_blocks"], budget)
    C = np.full((c_blocks, bm, bn), np.nan)
    for i in range(dp["nbr"]):
        for c0 in range(c_row_ptr[i], c_row_ptr[i + 1], blocks):
            cols = c_col[c0:min(c0 + blocks, c_row_ptr[i + 1])]
            for r0 in range(0, bm, rows):
                nr = min(rows, bm - r0)
                strip = np.zeros((len(cols), nr, bn))
                for rr in range(nr):
                    g = i * bm + r0 + rr
                    for e in range(a_ptr[g], a_ptr[g + 1]):
                        k = a_col[e]
                        if k >= rb.n_rows:
                            continue
                        for f in range(b_ptr[k], b_ptr[k + 1]):
                            j = b_col[f]
                            s = np.searchsorted(cols, j // bn)
                            if s < len(cols) and cols[s] == j // bn:
                                strip[s, rr, j % bn] += a_val[e] * b_val[f]
                C[c0:c0 + len(cols), r0:r0 + nr] = strip
    assert not np.isnan(C).any()        # every C entry written once
    return C


@pytest.mark.parametrize("case", list(CASES))
def test_spgemm_over_live_entries_matches_plain_and_reference(case):
    a, b, ja, jb, plan = _pair(case)
    ra, rb = tk._spgemm_layout(a), tk._spgemm_layout(b)
    assert (ra is rb) == (b is a)
    # each operand's RowLayout: CSR of its unscaled live-slot blocks over
    # the padded rows, each row's entries in column order
    for bsr, lay in ((a, ra), (b, rb)):
        assert lay.n_rows == bsr.nbr * bsr.bm
        assert lay.row_ptr.dtype == torch.int64 and lay.col.dtype == \
            torch.int32 and lay.val.dtype == torch.float64
        ptr = lay.row_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == lay.nnz and (np.diff(ptr) >= 0
                                                       ).all()
        want = _dense_terms(bsr)
        got = np.zeros_like(want)
        r = np.repeat(np.arange(lay.n_rows), np.diff(ptr))
        np.add.at(got, (r, lay.col.numpy()), lay.val.numpy())
        np.testing.assert_array_equal(got, want)
        assert (lay.val.numpy() != 0).all()
        c = lay.col.numpy()
        assert (c[1:][r[1:] == r[:-1]] >= c[:-1][r[1:] == r[:-1]]).all()
    # the device plan: each C block row's run of c_block_ij, its columns
    dp = tk._device_plan(plan, CPU)
    cij = plan.c_block_ij
    ptr = dp["c_row_ptr"].numpy()
    assert dp["nbr"] == cij[-1, 0] + 1 and len(ptr) == dp["nbr"] + 1
    np.testing.assert_array_equal(np.repeat(np.arange(dp["nbr"]),
                                            np.diff(ptr)), cij[:, 0])
    np.testing.assert_array_equal(dp["c_col"].numpy(), cij[:, 1])
    assert dp["max_row_blocks"] == np.diff(ptr).max()
    assert "a_idx" not in dp            # the kernel's arrays only
    # the kernel's walk, whole strips and strips cut small (chunks of two
    # blocks, and rows of one block), gives the same bits each way
    plain = tk._spgemm_plain(plan, a, b).numpy()
    row_bytes = 8 * b.bn + 4
    walks = [_walk(ra, rb, dp, a.bm, b.bn, plan.c_blocks, budget)
             for budget in (None, 2 * (8 * a.bm * b.bn + 4), 2 * row_bytes)]
    assert tk._strip_chunks(a.bm, b.bn, 99, 2 * row_bytes) == (2, 1)
    for w in walks[1:]:
        np.testing.assert_array_equal(w, walks[0])
    scale = max(float(np.abs(plain).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(walks[0], plain, rtol=RTOL, atol=RTOL * scale)
    # both against the reference's Pallas SpGEMM (interpret mode)
    jplan = jk.spgemm_plan(ja, jb)
    np.testing.assert_array_equal(plan.c_block_ij, jplan.c_block_ij)
    jC, _ = jk.spgemm(jplan, ja, jb, use_pallas=True)
    np.testing.assert_allclose(walks[0], np.asarray(jC), rtol=0,
                               atol=BSR_ATOL)
    np.testing.assert_allclose(plain, np.asarray(jC), rtol=0, atol=BSR_ATOL)
    C, _ = tk.spgemm(plan, a, b)
    assert torch.equal(C, torch.as_tensor(plain))


def test_spgemm_layout_is_kept_and_rebuilt_after_an_update():
    a, _, _, _, _ = _pair("edge_arrays")
    lay = tk._spgemm_layout(a)
    assert tk._spgemm_layout(a) is lay
    assert tk._live_layout(a) is not lay        # the SpMV layout is apart
    a.blocks.mul_(2.0)
    doubled = tk._spgemm_layout(a)
    assert doubled is not lay
    torch.testing.assert_close(doubled.val, 2.0 * lay.val, rtol=0, atol=0)
    a.mask[0, 1] = 0.0                          # the 0.5 slot drops out
    masked = tk._spgemm_layout(a)
    assert masked.nnz == doubled.nnz - 4 * 8


def test_strip_chunks():
    # whole 16x16 blocks: a Brusselator block row's 29 in one strip
    assert tk._strip_chunks(16, 16, 29) == (16, 29)
    assert tk._strip_chunks(16, 16, 29, 3 * (8 * 256 + 4)) == (16, 3)
    # a block past the budget: runs of rows of one block
    assert tk._strip_chunks(128, 128, 5) == (63, 1)
    assert tk._strip_chunks(300, 2000, 1, 1) == (1, 1)
    with pytest.raises(ValueError):
        tk._strip_chunks(1, 30000, 1)
