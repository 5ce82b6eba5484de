"""CLI benchmark driver: solve a MatrixMarket system with the sparse
solvers of russell_tpu_torch and print the StatsLinSol JSON record.

Counterpart of ``russell_tpu.bin.solve_matrix_market`` (reference contract:
russell_sparse/src/bin/solve_matrix_market.rs — structopt flags
(genie/ordering/scaling/verbose), read_matrix_market, factorize+solve,
VerifyLinSys residual metrics, the hardcoded bfwb62 oracle check
(:307-372), and the JSON stats output (:300)). It runs on the card unless
``--device`` names another (``cpu``).

Usage:
    python -m russell_tpu_torch.bin.solve_matrix_market path/to/matrix.mtx \
        [--genie auto|dense|banded|splu] [--ordering auto|rcm|amd] \
        [--scaling auto|no|max|row_col_iter] [--determinant] [--verbose] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def get_bfwb62_correct_x() -> np.ndarray:
    """The full known bfwb62 solution for rhs = ones — the componentwise
    oracle of the reference benchmark (solve_matrix_market.rs:307-372)."""
    return np.array([
        -1.02570048377040759e+05,
        -1.08800418159713998e+05,
        -7.87848688672370918e+04,
        -6.12550631774225840e+04,
        -1.16611533352550643e+05,
        -8.91949258261042705e+04,
        -5.57584825429375196e+04,
        -3.37535346291137103e+04,
        -6.74159236038033268e+04,
        -5.61065283435406673e+04,
        -3.69561341372605821e+04,
        -2.67385128650871302e+04,
        -4.67349124343154253e+04,
        -4.18861901056076676e+04,
        -4.34393771636046149e+04,
        -1.11210692731083000e+04,
        -1.16010526640020762e+04,
        -4.31993854681577286e+04,
        -5.82924327463857844e+03,
        -2.42374319876188747e+04,
        -2.39432136682168457e+04,
        5.27355041927211232e+02,
        -1.24769422505944240e+04,
        -1.47005934749971748e+04,
        -4.95701604733381391e+04,
        -1.38451884223610182e+03,
        -1.57972501695015781e+04,
        -5.19172705598900066e+04,
        -4.99494464999615593e+04,
        -1.19678659380488571e+04,
        -1.56190973892000347e+04,
        -6.18809904102459404e+03,
        -1.05693761694190998e+04,
        -2.93013328593191145e+04,
        -9.15514607143451940e+03,
        -1.27058094439569140e+04,
        -1.93936053067287430e+04,
        -6.84836276779992295e+03,
        -1.07869319688850719e+04,
        -4.61926223513438963e+04,
        -1.99579363156562504e+04,
        -7.83564896339727693e+03,
        -6.37173129434054590e+03,
        -1.88075622025074267e+03,
        -8.71648101674354621e+03,
        -1.21683775603205122e+04,
        -1.91184585274694587e+03,
        -5.64233479410600103e+03,
        -6.47747230904305070e+03,
        -4.47783973932844674e+03,
        -9.82971659947420812e+03,
        -1.95594295004403466e+04,
        -2.09457080830507803e+04,
        -5.46686114796283709e+03,
        -5.28888244321673483e+03,
        -2.07962090362636227e+04,
        -9.33272319073228937e+03,
        1.96672299472196187e+02,
        -4.40813445835840230e+03,
        -4.87188111893421956e+03,
        -1.75640594405328884e+04,
        -1.77959327708208002e+04])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix", help="path to a MatrixMarket .mtx file")
    ap.add_argument("--genie", default="auto",
                    choices=["auto", "dense", "banded", "splu"])
    ap.add_argument("--ordering", default="auto")
    ap.add_argument("--scaling", default="auto")
    ap.add_argument("--determinant", action="store_true")
    ap.add_argument("--error-analysis", action="store_true",
                    help="backward/forward error estimates "
                         "(MUMPS ICNTL(11) analog)")
    ap.add_argument("--condition-numbers", action="store_true",
                    help="cond1/cond2 estimates via power iteration")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--x64", action="store_true", default=True,
                    help="accepted for the reference CLI's flags; the "
                         "port always runs in f64")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: the card)")
    args = ap.parse_args(argv)

    from russell_tpu_torch.sparse import (Genie, LinSolParams, LinSolver,
                                          VerifyLinSys, read_matrix_market)
    from russell_tpu_torch.sparse.enums import Ordering, Scaling

    coo_real, coo_cplx = read_matrix_market(args.matrix)
    coo = coo_real if coo_real is not None else coo_cplx
    params = LinSolParams(ordering=Ordering(args.ordering),
                          scaling=Scaling(args.scaling),
                          compute_determinant=args.determinant,
                          compute_error_estimates=args.error_analysis,
                          compute_condition_numbers=args.condition_numbers,
                          verbose=args.verbose)
    solver = LinSolver(Genie.from_name(args.genie), device=args.device)
    solver.factorize(coo, params)
    rhs = np.ones(coo.nrow, dtype=coo.values.dtype)
    x = solver.solve(rhs).cpu().numpy()
    verify = VerifyLinSys.from_system(coo, x, rhs)
    solver.stats.matrix["name"] = args.matrix.rsplit("/", 1)[-1]
    solver.stats.verify = {
        "max_abs_a": verify.max_abs_a,
        "max_abs_ax": verify.max_abs_ax,
        "max_abs_diff": verify.max_abs_diff,
        "relative_error": verify.relative_error,
    }

    # bfwb62 oracle (solve_matrix_market.rs:217-230)
    if "bfwb62" in args.matrix:
        correct = get_bfwb62_correct_x()
        got = x[: len(correct)]
        diff = np.max(np.abs(got - correct) / np.abs(correct))
        ok = diff < 1e-10
        solver.stats.verify["bfwb62_oracle_rel_diff"] = float(diff)
        solver.stats.verify["bfwb62_oracle_ok"] = bool(ok)
        if not ok:
            print(solver.stats.get_json())
            print("ERROR: bfwb62 oracle check FAILED", file=sys.stderr)
            return 1

    print(solver.stats.get_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
