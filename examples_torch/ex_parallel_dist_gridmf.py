"""Distributed GRIDMF multifrontal factorization over the ranks of a
process group: the congruent-front node axis is split blockwise, so
children stay on their parent rank and the extend-add needs no traffic
until the top log2(ranks) depths, where the children Schur complements
are all-gathered (the MUMPS MPI subtree-ownership role). Shown on a world
of one (a file store in a temporary directory, gloo on the CPU, NCCL on
the card); the same code runs on every rank of a larger world.

Usage: python examples_torch/ex_parallel_dist_gridmf.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from russell_tpu_torch.parallel import (dist_gridmf_factorize,
                                        dist_gridmf_solve,
                                        initialize_multihost, make_mesh)
from russell_tpu_torch.sparse import gridmf as _gridmf
from russell_tpu_torch.sparse import samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

coo = samples.laplacian_2d(32)
ii, jj, vv = coo.triplets()
plan = _gridmf.gridmf_analyze(coo.nrow, np.asarray(ii), np.asarray(jj),
                              (32, 32, 1), leaf_cells=4)
vals = torch.as_tensor(vv, device=device)
rhs = torch.as_tensor(np.linspace(1.0, 2.0, coo.nrow), device=device)

own = not dist.is_initialized()
with tempfile.TemporaryDirectory() as tmp:
    initialize_multihost(init_method=f"file://{tmp}/store", num_processes=1,
                         process_id=0, device=device)
    try:
        mesh = make_mesh(dist.get_world_size(), device=device)
        print("mesh:", mesh)
        print("levels:", len(plan.levels),
              "leaf fronts:", plan.levels[-1].n_nodes)
        fac = dist_gridmf_factorize(mesh, plan, vals)
        x = dist_gridmf_solve(mesh, plan, fac, rhs).cpu().numpy()
    finally:
        if own:
            dist.destroy_process_group()

r = np.asarray(coo.as_dense()) @ x - rhs.cpu().numpy()
print("max |Ax-b| =", np.max(np.abs(r)))
assert np.max(np.abs(r)) < 1e-9

# the split result matches the single-device factorization
fac1 = _gridmf.gridmf_factorize(plan, vals)
x1 = _gridmf.gridmf_solve(plan, fac1, rhs).cpu().numpy()
assert np.max(np.abs(x - x1)) < 1e-10
print("distributed gridmf OK")
