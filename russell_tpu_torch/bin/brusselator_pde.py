"""CLI benchmark driver: Brusselator PDE via Radau5.

Counterpart of ``russell_tpu.bin.brusselator_pde`` (reference contract:
russell_ode/src/bin/brusselator_pde.rs (structopt: npoint / tol /
second-book / no-dense-output, lines 9-50), producing the run logs in
russell_ode/data/logs/brus_pde_*.txt). With default Params the genie is
AUTO, which takes GRIDMF at the default npoint; the integration runs
fused (one captured CUDA graph a step attempt) unless ``--no-fused``. It
runs on the card unless ``--device`` names another (``cpu``).

Usage:
    python -m russell_tpu_torch.bin.brusselator_pde [--npoint 129] \
        [--tol 1e-4] [--tf 1.0] [--alpha 2e-3] [--second-book] \
        [--no-fused] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--npoint", type=int, default=129)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--tf", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=2e-3)
    ap.add_argument("--second-book", action="store_true")
    ap.add_argument("--no-fused", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to integrate on (default: the card)")
    args = ap.parse_args(argv)

    import torch
    from russell_tpu_torch.ode import Method, OdeSolver, Params, samples

    system, t0, yy0, _ = samples.brusselator_pde(
        args.alpha, args.npoint, second_book=args.second_book)
    params = Params(Method.RADAU5)
    params.set_tolerances(args.tol, args.tol)
    solver = OdeSolver(params, system, device=args.device)

    t_start = time.perf_counter()
    y = solver.solve(yy0, t0, args.tf, args=None, fused=not args.no_fused)
    if y.device.type == "cuda":
        torch.cuda.synchronize(y.device)
    wall = time.perf_counter() - t_start

    st = solver.stats()
    yv = y.cpu().numpy()
    print(f"brusselator_pde: npoint={args.npoint} "
          f"ndim={system.ndim} jac_nnz={system.jac_nnz} "
          f"second_book={args.second_book}")
    print(st.summary())
    print(f"total wall time = {wall:.3f} s")
    print(f"y[0] = {float(yv[0]):.10e}")
    print(f"finite = {bool(torch.isfinite(y).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
