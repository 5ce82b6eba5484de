"""Data-parallel batched solves over the ranks of a process group, one
device each (the counterpart of the reference rayon multithreaded-solvers
test). Shown on a world of one (a file store in a temporary directory,
gloo on the CPU, NCCL on the card); the same code runs on every rank of
a larger world, each rank solving its share of the batch.

Usage: python examples_torch/ex_parallel_batch_mesh.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np
import torch.distributed as dist

from russell_tpu_torch.parallel import (batch_factor_solve,
                                        initialize_multihost, make_mesh)
from russell_tpu_torch.sparse import factor as _factor
from russell_tpu_torch.sparse import samples
from russell_tpu_torch.sparse.enums import Genie

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

own = not dist.is_initialized()
with tempfile.TemporaryDirectory() as tmp:
    initialize_multihost(init_method=f"file://{tmp}/store", num_processes=1,
                         process_id=0, device=device)
    try:
        mesh = make_mesh(min(8, dist.get_world_size()), device=device)
        coo = samples.laplacian_2d(12)
        ii, jj, vv = coo.triplets()
        plan = _factor.analyze(coo.nrow, ii, jj, genie=Genie.BANDED)
        B = 2 * mesh.size()
        scale = 1.0 + 0.1 * np.arange(B)[:, None]
        bvals = np.tile(np.asarray(vv)[None, :], (B, 1)) * scale
        brhs = np.tile(np.linspace(1.0, 2.0, coo.nrow)[None, :], (B, 1))
        X = batch_factor_solve(mesh, plan, bvals, brhs).cpu().numpy()
    finally:
        if own:
            dist.destroy_process_group()

A = coo.as_dense()
for i in (0, B - 1):
    r = np.max(np.abs(float(scale[i, 0]) * A @ X[i] - brhs[i]))
    print(f"batch {i}: residual = {r:.2e}")
    assert r < 1e-10
print(f"solved {B} systems across {mesh.size()} devices; ok")
