"""Nested-dissection sparse LU: symbolic analysis, level-batched numeric
factorization (its block-pair products the ``splu_pairs`` kernel, its
row gathers ``gather_rows``, its pivot blocks ``gj_inv``), and the
mesh-distributed variant over the ranks of a process group (here a world
of one: a file store in a temporary directory, gloo on the CPU, NCCL on
the card).

Usage: python examples_torch/ex_sparse_nd_splu.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from russell_tpu_torch.parallel import (dist_splu_factorize,
                                        initialize_multihost, make_mesh)
from russell_tpu_torch.sparse import samples, splu

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

def main():
    coo = samples.laplacian_2d(32)          # 1024 x 1024, 5-point stencil
    ii, jj, vv = map(np.asarray, coo.triplets())
    n = coo.nrow
    # symbolic: nested dissection -> wide elimination-tree levels
    plan = splu.splu_analyze(n, ii, jj, block_size=16, ordering="nd")
    print(f"n={n}: {plan.nb} block columns, {plan.nblk - 1} stored blocks, "
          f"{plan.lvl_cols.shape[0]} level chunks "
          f"(vs {plan.nb} sequential steps without the tree)")

    # numeric: level-batched inverse-based elimination (all GEMMs)
    vals = torch.as_tensor(vv, device=device)
    fac = splu.splu_factorize(plan, vals)
    b = np.linspace(1.0, 2.0, n)
    bt = torch.as_tensor(b, device=device)
    x = splu.splu_solve(plan, fac, bt).cpu().numpy()
    A = np.asarray(coo.as_dense())
    r = np.max(np.abs(A @ x - b))
    print(f"single-chip residual: {r:.2e}   log|det| = "
          f"{float(fac['logdet']):.6f}")

    # distributed: each row's block pairs split over the ranks of the
    # mesh (all-reduced Schur updates): same factorization, usable with
    # the same solve
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        initialize_multihost(init_method=f"file://{tmp}/store",
                             num_processes=1, process_id=0, device=device)
        try:
            mesh = make_mesh(min(8, dist.get_world_size()), device=device)
            fac_d = dist_splu_factorize(mesh, plan, vals)
            xd = splu.splu_solve(plan, fac_d, bt).cpu().numpy()
        finally:
            if own:
                dist.destroy_process_group()
    print(f"distributed == single-chip: {np.max(np.abs(x - xd)):.2e}")


if __name__ == "__main__":
    main()
