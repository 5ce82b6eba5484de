"""Sanity driver: run every solver genie through factorize/solve on the
sample registry (real and complex).

Counterpart of ``russell_tpu.bin.mem_check`` (reference contract:
russell_sparse/src/bin/mem_check.rs:5 — the valgrind harness target).
Each case is factorized and solved twice on one LinSolver: the residual
must be small and the second solution equal the first. On the card the
bytes the live tensors requested (the caching allocator's
``requested_bytes``) after the first and the second factorize-and-solve
are printed, and the second must not exceed the first (no state leaks
from one factorization to the next). ``memory_allocated()`` would count
whole cached blocks: a free block up to 1 MB larger than a request is
handed out unsplit, so the same live tensors can read up to ~1 MB apart
from one run to the next. Every
error counts as a failure; the exit code is 1 if any case failed. It
runs on the card unless ``--device`` names another (``cpu``).

Usage:
    python -m russell_tpu_torch.bin.mem_check [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import russell_tpu_torch
    from russell_tpu_torch.sparse import (Genie, LinSolver, VerifyLinSys,
                                          samples)

    dev = russell_tpu_torch.device(args.device)
    cases = [
        ("umfpack_unsymmetric_5x5", samples.umfpack_unsymmetric_5x5(dev)[0]),
        ("mkl_unsymmetric_5x5", samples.mkl_unsymmetric_5x5(dev)[0]),
        ("positive_definite_3x3_lower",
         samples.positive_definite_3x3_lower(dev)[0]),
        ("mkl_symmetric_5x5_full", samples.mkl_symmetric_5x5_full(dev)[0]),
        ("complex_symmetric_3x3_full",
         samples.complex_symmetric_3x3_full(dev)[0]),
        ("umfpack_complex_unsymmetric_5x5",
         samples.umfpack_complex_unsymmetric_5x5(dev)[0]),
        ("laplacian_2d(12)", samples.laplacian_2d(12)),
    ]
    genies = [Genie.DENSE, Genie.BANDED, Genie.SPLU]

    def factorize_and_solve(solver, coo, rhs):
        solver.factorize(coo)
        x = solver.solve(rhs).cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return x, (torch.cuda.memory_stats(dev)[
            "requested_bytes.all.current"] if dev.type == "cuda" else None)

    failures = 0
    for name, coo in cases:
        for genie in genies:
            rel = float("nan")
            mem = ""
            try:
                solver = LinSolver(genie, device=dev)
                rhs = np.ones(coo.nrow, dtype=coo.values.dtype)
                x, m1 = factorize_and_solve(solver, coo, rhs)
                rel = VerifyLinSys.from_system(coo, x, rhs).relative_error
                ok = rel < 1e-8
                # repeat factorize/solve on the same structure
                x2, m2 = factorize_and_solve(solver, coo, rhs)
                ok = ok and np.allclose(x, x2)
                if m1 is not None:
                    mem = f" requested={m1}->{m2} B"
                    ok = ok and m2 <= m1
                status = "OK " if ok else "FAIL"
                if not ok:
                    failures += 1
            # every error is the case's failure, reported on its line
            except Exception as exc:  # noqa: BLE001
                status = f"ERR {exc}"
                failures += 1
            print(f"{status} {genie.value:>6} {name} (rel_err={rel:.2e})"
                  f"{mem}")
    print(f"\n{failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
