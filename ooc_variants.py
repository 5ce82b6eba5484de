#!/usr/bin/env python3
"""How the host memory of GRIDMF's out-of-core factors is pinned, timed on
one NVIDIA GPU: how ``russell_tpu_torch/sparse/gridmf.py``'s design was
chosen.

Each variant factorizes ``samples.laplacian_3d(60)`` with the grid hint
(60, 60, 60) out of core (``factor.GRIDMF_BUDGET_GB`` set under its 13.2
GiB of f64 factors) and solves it once:

- ``upfront`` (the package's): every store mapped with its pages made by
  the kernel (``MAP_POPULATE``) and registered whole with
  ``cudaHostRegister`` before the first depth (``gridmf._ooc_stores``);
- ``lazy``: the same without ``MAP_POPULATE``: the registration makes the
  pages;
- ``chunk``: the stores mapped unregistered, and the pages each chunk's
  copy reaches registered just before it (one registration a chunk and
  store, each copy cut where two registrations meet), while the card
  computes;
- ``torch_pinned``: each store from torch's pinned allocator
  (``pin_memory=True``, which rounds each request up to a power of two).

It prints the card's name and power limit, then one JSON line per run: the
factorization's wall, the seconds spent making and pinning the stores
(``cudaHostRegister``, or the mappings and the registrations in the
package's ``_host_empty``, or the pinned allocations), the bytes pinned,
whether x has the first run's bits, and the solve's wall. The variants run
in turns, forward then backward, after one in-core factorization that
builds ``gj_inv`` and warms the card.
Run from the repository root:

    python3 ooc_variants.py
"""

from __future__ import annotations

import json
import mmap
import subprocess
import time
import weakref

import numpy as np
import torch

from russell_tpu_torch.sparse import factor, gridmf, samples
from russell_tpu_torch.sparse.enums import Genie

NPOINT = 60
PAGE = 4096
VARIANTS = ("upfront", "lazy", "chunk", "torch_pinned")

_clock = {"register_s": 0.0}


def timed(fn):
    """``fn`` adding its seconds to ``_clock``."""
    def run(*args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            _clock["register_s"] += time.perf_counter() - t
    return run


def _mapped(shape, dtype):
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = mmap.mmap(-1, -(-nbytes // PAGE) * PAGE,
                    flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    return torch.frombuffer(buf, dtype=torch.uint8)[:nbytes].view(
        dtype).view(shape), buf


def _unpin_ranges(ptr, ranges, buf):
    for a, _ in ranges:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr + a))


def _base(t):
    """The tensor over the whole mapping that ``t``, a view from its start
    (a store, or a Schur buffer's slice), belongs to."""
    return t if t._base is None else t._base


def chunk_empty(shape, dtype, device):
    """A store registered later, a page range at a time (``chunk_pin``)."""
    if not int(np.prod(shape)):
        return torch.empty(shape, dtype=dtype)
    t, buf = _mapped(shape, dtype)
    root = _base(t)
    root._ranges = []
    root._pinned = 0
    weakref.finalize(root, _unpin_ranges, t.data_ptr(), root._ranges, buf)
    return t


@timed
def chunk_pin(t, nbytes):
    t = _base(t)
    done = t._ranges[-1][1] if t._ranges else 0
    want = -(-nbytes // PAGE) * PAGE
    if want > done:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            t.data_ptr() + done, want - done, 0))
        t._ranges.append((done, want))
        t._pinned = want


def spans(t, lo, hi):
    item = t.element_size()
    cuts = [(max(lo, a // item), min(hi, b // item))
            for a, b in getattr(_base(t), "_ranges",
                                [(0, t.numel() * item)])]
    return [(a, b) for a, b in cuts if a < b]


def chunk_to_host(self, host, lo, src):
    n = src.numel()
    if not n:
        return
    chunk_pin(host, (lo + n) * host.element_size())
    flat, s = host.view(-1), src.reshape(-1)
    self.down.wait_stream(torch.cuda.current_stream(self.device))
    with torch.cuda.stream(self.down):
        for a, b in spans(host, lo, lo + n):
            flat[a:b].copy_(s[a - lo:b - lo], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    src.record_stream(self.down)
    self.pending.append((ev, n * src.element_size()))
    self.inflight += n * src.element_size()
    while self.inflight > self.limit and len(self.pending) > 1:
        ev, nb = self.pending.popleft()
        ev.synchronize()
        self.inflight -= nb


def chunk_to_device(self, host, lo=0, hi=None, shape=None):
    hi = host.numel() if hi is None else hi
    shape = host.shape if shape is None else shape
    flat = host.view(-1)
    with torch.cuda.stream(self.up):
        out = torch.empty(hi - lo, dtype=host.dtype, device=self.device)
        for a, b in spans(host, lo, hi):
            out[a - lo:b - lo].copy_(flat[a:b], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    return out.view(shape), ev


def lazy_empty(shape, dtype, device):
    """``gridmf._host_empty`` without MAP_POPULATE."""
    if not int(np.prod(shape)):
        return torch.empty(shape, dtype=dtype)
    t, buf = _mapped(shape, dtype)
    nbytes = t.numel() * t.element_size()
    torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), nbytes, 0))
    t._pinned = nbytes
    weakref.finalize(t, _unpin_ranges, t.data_ptr(), [(0, nbytes)], buf)
    return t


def torch_pinned_empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


ORIG = {"_host_empty": gridmf._host_empty}
ORIG_COPIES = {"to_host": gridmf._Copies.to_host,
               "to_device": gridmf._Copies.to_device}


def use(variant):
    for k, v in ORIG.items():
        setattr(gridmf, k, v)
    for k, v in ORIG_COPIES.items():
        setattr(gridmf._Copies, k, v)
    if variant == "chunk":
        gridmf._host_empty = chunk_empty
        gridmf._Copies.to_host = chunk_to_host
        gridmf._Copies.to_device = chunk_to_device
    else:
        gridmf._host_empty = timed({"upfront": ORIG["_host_empty"],
                                    "lazy": lazy_empty,
                                    "torch_pinned": torch_pinned_empty}[
                                        variant])


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    coo = samples.laplacian_3d(NPOINT)
    ii, jj, vv = map(np.asarray, coo.triplets())
    vals = torch.as_tensor(vv, device="cuda")
    b = torch.as_tensor(np.sin(np.arange(coo.nrow)), device="cuda")
    factor.GRIDMF_BUDGET_GB = 1.0
    plan = factor.analyze(coo.nrow, ii, jj, genie=Genie.GRIDMF,
                          grid=(NPOINT, NPOINT, NPOINT))
    assert plan.gridmf_ooc
    # one in-core factorization first: gj_inv is built and the card warm
    gridmf.gridmf_factorize(plan.gridmf_plan, vals)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    first = None
    for variant in VARIANTS + VARIANTS[::-1]:
        use(variant)
        _clock["register_s"] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fac = factor.numeric_factorize(plan, vals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reg = _clock["register_s"]
        t0 = time.perf_counter()
        x = factor.factor_solve(plan, fac, b)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        first = x if first is None else first
        print(json.dumps({
            "variant": variant, "factorize_s": wall, "pin_s": reg,
            "pinned_bytes": sum(getattr(_base(t), "_pinned", 0) or (
                t.numel() * t.element_size() if t.is_pinned() else 0)
                for st in fac["levels"] for t in st.values()
                if t is not None),
            "solve_s": solve, "x_bits_equal": bool(torch.equal(x, first))}),
            flush=True)
        del fac, x
    use("upfront")


if __name__ == "__main__":
    main()
