"""The live-entry layout (SELL-32) that the port's SpMV and SpMM kernels
read, on the CPU: it densifies to the BSR matrix it came from, and a
product over it with the kernels' indexing gives the reference package's
interpret-mode Pallas products on the same seeded inputs."""

import numpy as np
import pytest
import torch

from russell_tpu.sparse import kernels as jk
from russell_tpu.sparse.coo import CooMatrix as JCoo
from russell_tpu_torch.ode import samples as tode_samples
from russell_tpu_torch.sparse import kernels as tk
from russell_tpu_torch.sparse import samples as ts
from russell_tpu_torch.sparse.coo import CooMatrix

CPU = "cpu"
RTOL = 1e-12
S = tk.SLICE_ROWS


def _random(nrow, ncol, nnz, row_hi, seed):
    rng = np.random.default_rng(seed)
    return (nrow, ncol, rng.integers(0, row_hi, nnz),
            rng.integers(0, ncol, nnz), rng.standard_normal(nnz))


def _long_row():
    """A 5-point Laplacian of 12 x 12 with row 7 full: one slice 144 wide."""
    lap = ts.laplacian_2d(12)
    ii, jj, vv = (np.asarray(a) for a in lap.triplets())
    n = lap.nrow
    return (n, n, np.concatenate([ii, np.full(n, 7)]),
            np.concatenate([jj, np.arange(n)]),
            np.concatenate([vv, np.linspace(-1.0, 1.0, n)]))


def _stored_zeros():
    """Entries that sum to zero and explicit zeros: stored, never live."""
    n, _, ii, jj, vv = _random(70, 70, 300, 70, 31)
    return (n, n, np.concatenate([ii, ii[:50], [3, 9]]),
            np.concatenate([jj, jj[:50], [4, 9]]),
            np.concatenate([vv, -vv[:50], [0.0, 0.0]]))


def _brusselator(npoint):
    system, t0, y0, _ = tode_samples.brusselator_pde(2e-3, npoint)
    ii, jj = system.jac_structure
    jv = system.jacobian(t0, torch.as_tensor(y0), None).numpy()
    return system.ndim, system.ndim, ii, jj, jv


# (triplets, bm, bn): ragged last slices, pads, zero-valued stored entries,
# empty rows, an all-empty matrix, one long row, the Brusselator Jacobian
CASES = {
    "lap15_8x128": (lambda: ts.laplacian_2d(15), 8, 128),
    "lap10_16x16": (lambda: ts.laplacian_2d(10), 16, 16),
    "rect37x300_8x128": (lambda: _random(37, 300, 400, 37, 21), 8, 128),
    "irregular500_8x128": (lambda: ts.irregular_geometric(500), 8, 128),
    "empty_tail_16x16": (lambda: _random(100, 100, 300, 40, 22), 16, 16),
    "stored_zeros_8x16": (_stored_zeros, 8, 16),
    "all_empty_8x128": (lambda: (45, 45, [], [], np.zeros(0)), 8, 128),
    "long_row_4x8": (_long_row, 4, 8),
    "brusselator9_8x128": (lambda: _brusselator(9), 8, 128),
}


def _pair(case):
    """The case's COO in both packages, and its BSR in each."""
    make, bm, bn = CASES[case]
    t = make()
    if isinstance(t, CooMatrix):
        t = (t.nrow, t.ncol, *(np.asarray(a) for a in t.triplets()))
    coo = CooMatrix.from_arrays(*t)
    jcoo = JCoo.from_arrays(*t)
    return (coo, tk.bsr_from_coo(coo, bm, bn, device=CPU),
            jk.bsr_from_coo(jcoo, bm, bn))


def _slot_rows(lay):
    """The row of every slot of ``lay``: slot p of slice s is lane
    (p - slice_off[s]) % 32 of it."""
    widths = torch.diff(lay.slice_off)
    s = torch.repeat_interleave(torch.arange(lay.n_slices), widths)
    return s * S + (torch.arange(lay.val.numel()) - lay.slice_off[s]) % S


def _densify(lay):
    d = torch.zeros((lay.n_slices * S, lay.n_cols), dtype=torch.float64)
    d.index_put_((_slot_rows(lay), lay.col.long()), lay.val,
                 accumulate=True)
    return d[:lay.n_rows]


def _bsr_dense(bsr):
    """blocks * mask laid out densely, cut to (n_rows, n_cols)."""
    nbc = max(int(bsr.col_ids.max()) + 1, -(-bsr.n_cols // bsr.bn))
    d = torch.zeros((bsr.nbr, bsr.bm, nbc, bsr.bn), dtype=torch.float64)
    w = bsr.blocks * bsr.mask.reshape(-1, 1, 1)
    for k, (r, c) in enumerate(zip(
            np.repeat(np.arange(bsr.nbr), bsr.blocks_per_row),
            bsr.col_ids.reshape(-1).tolist())):
        d[r, :, c] += w[k]
    return d.reshape(bsr.nbr * bsr.bm, nbc * bsr.bn)[:bsr.n_rows,
                                                     :bsr.n_cols]


def _sell_matmat(lay, X):
    """Y = A X over ``lay`` with the kernels' indexing: row 32 s + l adds
    val * X[col] at slot slice_off[s] + 32 k + l for k = 0, 1, ... below
    its slice's width, in that order."""
    width = torch.diff(lay.slice_off) // S
    Y = torch.zeros((lay.n_slices, S, X.shape[1]), dtype=torch.float64)
    lanes = torch.arange(S)
    for k in range(int(width.max()) if lay.n_slices else 0):
        s = torch.nonzero(width > k).reshape(-1)
        p = (lay.slice_off[s, None] + k * S + lanes).reshape(-1)
        Y[s] += (lay.val[p, None] * X[lay.col[p].long()]).reshape(
            len(s), S, -1)
    return Y.reshape(-1, X.shape[1])[:lay.n_rows]


@pytest.mark.parametrize("case", list(CASES))
def test_live_layout_densifies_to_its_bsr(case):
    coo, bsr, _ = _pair(case)
    lay = tk._live_layout(bsr)
    assert lay.n_slices == -(-coo.nrow // S)
    assert lay.val.dtype == torch.float64 and lay.col.dtype == torch.int32
    assert lay.slice_off.dtype == torch.int64 and int(lay.slice_off[0]) == 0
    torch.testing.assert_close(_densify(lay), _bsr_dense(bsr), rtol=0,
                               atol=0)
    # every live entry once; each slice as wide as its longest row; pads
    # hold 0 and their row's last column; a row's entries in column order
    live = lay.val != 0
    assert int(live.sum()) == lay.nnz == int((_bsr_dense(bsr) != 0).sum())
    rows = _slot_rows(lay)
    row_len = torch.bincount(rows[live], minlength=lay.n_slices * S)
    widths = torch.diff(lay.slice_off) // S
    assert torch.equal(widths, row_len.view(-1, S).amax(1))
    # the slots of each row in step order: its entries, then its pads
    order = torch.sort(rows, stable=True).indices
    r, c, v = rows[order], lay.col[order].long(), lay.val[order]
    slots = torch.bincount(r, minlength=lay.n_slices * S)
    first = torch.cumsum(slots, 0) - slots
    is_entry = torch.arange(r.numel()) - first[r] < row_len[r]
    assert torch.equal(is_entry, v != 0)
    same_row = (r[1:] == r[:-1]) & is_entry[1:]
    assert torch.all(c[1:][same_row] >= c[:-1][same_row])
    if r.numel():
        last = torch.where(row_len > 0, c[(first + row_len - 1).clamp(
            0, r.numel() - 1)], 0)
        assert torch.equal(c[~is_entry], last[r[~is_entry]])
    assert 0.0 <= lay.pad_share < 1.0 or lay.nnz == 0


# the cases held against the reference's interpret-mode kernels (about
# half a second a call), with the widths m of X for its SpMM
PRODUCT_CASES = {"brusselator9_8x128": (1, 16, 33), "rect37x300_8x128": (),
                 "empty_tail_16x16": (), "stored_zeros_8x16": (),
                 "all_empty_8x128": (), "long_row_4x8": ()}


@pytest.mark.parametrize("case", list(PRODUCT_CASES))
def test_products_over_the_layout_match_reference(case):
    coo, bsr, jbsr = _pair(case)
    lay = tk._live_layout(bsr)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(coo.ncol)
    want = np.asarray(jk.bsr_matvec(jbsr, x, use_pallas=True))
    got = _sell_matmat(lay, torch.as_tensor(x)[:, None])[:, 0]
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)
    for m in PRODUCT_CASES[case]:
        X = rng.standard_normal((coo.ncol, m))
        want = np.asarray(jk.bsr_matmat(jbsr, X, use_pallas=True))
        got = _sell_matmat(lay, torch.as_tensor(X))
        scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * scale)


def test_live_layout_drops_entries_past_n_rows_and_n_cols():
    # a 10 x 13 matrix in 4 x 8 blocks: its last block row holds rows
    # 10-11 and its last panel columns 13-15, all set, none live
    rng = np.random.default_rng(11)
    blocks = rng.standard_normal((3 * 2, 4, 8))
    col_ids = np.array([[0, 1], [1, 0], [1, 1]])
    mask = np.array([[1.0, 1.0], [1.0, 0.0], [1.0, 0.5]])
    bsr = tk.bsr_from_arrays(10, 13, 4, 8, blocks, col_ids, mask, CPU)
    lay = tk._live_layout(bsr)
    want = _bsr_dense(bsr)
    assert want.shape == (10, 13)
    torch.testing.assert_close(_densify(lay), want, rtol=0, atol=0)
    # block row 2 holds block column 1 twice: its rows 8-9 keep both
    live = [(blocks[r * 2 + s] * mask[r, s])[
        : max(0, min(4, 10 - 4 * r)), : max(0, min(8, 13 - 8 * col_ids[r,
                                                                     s]))]
        for r in range(3) for s in range(2)]
    assert int(lay.col.max()) < 13
    assert lay.nnz == sum(int(np.count_nonzero(b)) for b in live)
    x = rng.standard_normal(13)
    np.testing.assert_allclose(
        _sell_matmat(lay, torch.as_tensor(x)[:, None])[:, 0].numpy(),
        tk._bsr_matvec_plain(bsr, torch.as_tensor(x)).numpy(), rtol=RTOL,
        atol=RTOL * float(want.abs().max()))


def test_one_long_row_costs_its_slice_only():
    _, bsr, _ = _pair("long_row_4x8")
    lay = tk._live_layout(bsr)
    widths = (torch.diff(lay.slice_off) // S).tolist()
    assert widths[0] == 144 and max(widths[1:]) == 5
    assert lay.pad_share > 0.5


def test_in_place_changes_rebuild_the_cached_layout():
    _, bsr, _ = _pair("lap10_16x16")
    lay = tk._live_layout(bsr)
    assert tk._live_layout(bsr) is lay
    bsr.blocks.mul_(2.0)
    doubled = tk._live_layout(bsr)
    assert doubled is not lay
    torch.testing.assert_close(doubled.val, 2.0 * lay.val, rtol=0, atol=0)
    bsr.mask[0, 0] = 0.0
    masked = tk._live_layout(bsr)
    assert masked is not doubled and masked.nnz < doubled.nnz
    torch.testing.assert_close(_densify(masked), _bsr_dense(bsr), rtol=0,
                               atol=0)


def test_inference_tensors_build_the_layout_at_each_call():
    # tensors made under torch.inference_mode() have no version counter:
    # the layout is not cached, so an in-place change there is still seen
    coo, _, _ = _pair("lap10_16x16")
    with torch.inference_mode():
        bsr = tk.bsr_from_coo(coo, 16, 16, device=CPU)
        assert bsr.blocks.is_inference()
        lay = tk._live_layout(bsr)
        assert "_live_layout" not in bsr.__dict__
        torch.testing.assert_close(_densify(lay), _bsr_dense(bsr), rtol=0,
                                   atol=0)
        bsr.blocks.mul_(3.0)
        tripled = tk._live_layout(bsr)
    torch.testing.assert_close(tripled.val, 3.0 * lay.val, rtol=0, atol=0)
    # and outside inference mode, on the same inference tensors
    again = tk._live_layout(bsr)
    torch.testing.assert_close(again.val, tripled.val, rtol=0, atol=0)


def _complex_brusselator(npoint, seed):
    """J(y0) + i 0.3 noise: a complex128 matrix of the Jacobian's pattern
    (the pattern of Radau5's (alpha + i beta) M - J)."""
    n, _, ii, jj, jv = _brusselator(npoint)
    rng = np.random.default_rng(seed)
    return n, n, ii, jj, jv + 0.3j * rng.standard_normal(len(jv))


def test_complex_layouts_hold_complex_values_and_products_match_reference():
    t = _complex_brusselator(9, 5)
    coo = CooMatrix.from_arrays(*t)
    jcoo = JCoo.from_arrays(*t)
    A = np.zeros((t[0], t[1]), np.complex128)
    np.add.at(A, (t[2], t[3]), t[4])
    rng = np.random.default_rng(6)
    x = rng.standard_normal(coo.ncol) + 1j * rng.standard_normal(coo.ncol)
    X = (rng.standard_normal((coo.ncol, 16))
         + 1j * rng.standard_normal((coo.ncol, 16)))
    bsr = tk.bsr_from_coo(coo, 8, 128, device=CPU)
    jbsr = jk.bsr_from_coo(jcoo, 8, 128)
    assert bsr.blocks.dtype == torch.complex128
    # the live layout keeps the complex values, every live entry once
    lay = tk._live_layout(bsr)
    assert lay.val.dtype == torch.complex128 and lay.nnz == int(
        (A != 0).sum())
    dense = torch.zeros((lay.n_slices * S, lay.n_cols),
                        dtype=torch.complex128)
    dense.index_put_((_slot_rows(lay), lay.col.long()), lay.val,
                     accumulate=True)
    np.testing.assert_array_equal(dense[:lay.n_rows].numpy(), A)
    # the plain products against the reference's
    for got, want in (
            (tk.bsr_matvec(bsr, torch.as_tensor(x)),
             jk.bsr_matvec(jbsr, x, use_pallas=False)),
            (tk.bsr_matmat(bsr, torch.as_tensor(X)),
             jk.bsr_matmat(jbsr, X, use_pallas=False))):
        want = np.asarray(want)
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    # SpGEMM's RowLayout keeps them too, and A·A matches the reference's
    b16 = tk.bsr_from_coo(coo, 16, 16, device=CPU)
    jb16 = jk.bsr_from_coo(jcoo, 16, 16)
    rl = tk._spgemm_layout(b16)
    assert rl.val.dtype == torch.complex128 and rl.nnz == lay.nnz
    plan = tk.spgemm_plan(b16, b16)
    C, cij = tk.spgemm(plan, b16, b16)
    jC, jcij = jk.spgemm(jk.spgemm_plan(jb16, jb16), jb16, jb16,
                         use_pallas=False)
    np.testing.assert_array_equal(cij, np.asarray(jcij))
    want = np.asarray(jC)
    assert C.dtype == torch.complex128
    np.testing.assert_allclose(C.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
