"""GENMF: the general-matrix nested-dissection multifrontal engine on an
IRREGULAR sparse pattern, the role MUMPS/UMFPACK play on circuit/FEM
matrices (the reference Raj1/ASIC_680k benchmark class,
russell_sparse/data/logs/Raj1_MUMPS.json). No grid hint, no band
structure: the engine builds a nested-dissection tree on the general
adjacency graph and batches congruence-bucketed dense fronts, whose pivot
blocks the ``gj_inv`` kernel inverts.

Usage: python examples_torch/ex_sparse_genmf_irregular.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.sparse import Genie, LinSolver, VerifyLinSys, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# random-geometric graph: Poisson-irregular degrees, good separators
# (small n here; the same engine runs irregular_geometric(264_000))
coo = samples.irregular_geometric(1500, seed=3)
print(f"n = {coo.nrow}, nnz = {coo.nnz}")

sol = LinSolver(Genie.GENMF, device=device)
sol.factorize(coo)
st = sol.stats
assert st.output["effective_ordering"] == "nd-general"

b = np.sin(np.arange(coo.nrow))
x = sol.solve(b).cpu().numpy()
v = VerifyLinSys.from_system(coo, x, b)
print("relative_error =", v.relative_error)
assert v.relative_error < 1e-10

# the symbolic schedule exposes auditable flop/storage numbers
plan = sol.plan.genmf_plan
d = plan.stats_dict()
print("classes =", d["n_classes"], "fronts =", d["n_fronts"],
      "flops =", d["flops"], "store_f32_gb =", d["store_f32_gb"])
assert d["n_fronts"] >= d["n_classes"] > 0
print("genmf irregular OK")
