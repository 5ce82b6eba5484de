"""CLI driver: one-transistor amplifier DAE via Radau5.

Counterpart of ``russell_tpu.bin.amplifier1t`` (reference contract:
russell_ode/src/bin/amplifier1t.rs): solves the singular-mass DAE of
``samples.amplifier1t`` and prints the Radau5 stats (oracle log:
russell_ode/data/logs/fortran_radau5_amplifier1t.txt) and y. It runs on
the card unless ``--device`` names another (``cpu``).

Usage:
    python -m russell_tpu_torch.bin.amplifier1t [--tol 1e-4] [--tf 0.05] \
        [--h-out 0.001] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--tf", type=float, default=0.05)
    ap.add_argument("--h-out", type=float, default=0.001)
    ap.add_argument("--device", default="cuda",
                    help="torch device to integrate on (default: the card)")
    args = ap.parse_args(argv)

    from russell_tpu_torch.ode import (Method, OdeSolver, Output, Params,
                                       samples)

    system, x0, y0, _ = samples.amplifier1t()
    params = Params(Method.RADAU5)
    params.set_tolerances(args.tol, args.tol)
    params.step.h_ini = 1e-6
    solver = OdeSolver(params, system, device=args.device)
    out = Output().set_dense_h_out(args.h_out).set_dense_recording([0, 4])

    t_start = time.perf_counter()
    y = solver.solve(y0, x0, args.tf, args=None, output=out)
    yv = y.cpu().numpy()
    wall = time.perf_counter() - t_start

    print(solver.stats().summary())
    print(f"total wall time = {wall:.3f} s")
    for i, v in enumerate(yv):
        print(f"y[{i}] = {v:.10e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
