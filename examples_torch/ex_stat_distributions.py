"""Probability distributions: pdf/cdf oracles, sampling on the device
from an explicitly seeded torch.Generator, Statistics, and an ASCII
Histogram (mirrors russell_stat examples/stat_distribution_*.rs +
histogram usage).

Usage: python examples_torch/ex_stat_distributions.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch

from russell_tpu_torch.stat import (DistributionGumbel, DistributionLognormal,
                                    DistributionNormal, DistributionUniform,
                                    Histogram, Statistics)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# Gumbel from (mu, sigma) like the reference new_from_mu_sig
g = DistributionGumbel.new_from_mu_sig(2.0, 1.5)
assert abs(g.mean() - 2.0) < 1e-12
assert abs(math.sqrt(g.variance()) - 1.5) < 1e-12

# normal pdf/cdf point oracles
nrm = DistributionNormal(0.0, 1.0)
assert abs(float(nrm.pdf(0.0, device)) - 1.0 / math.sqrt(2 * math.pi)) < 1e-12
assert abs(float(nrm.cdf(0.0, device)) - 0.5) < 1e-12

# sampling is a function of an explicit generator (vectorized on device)
gen = torch.Generator(device=device).manual_seed(42)
samples = {
    "uniform": DistributionUniform(0.0, 1.0).sample(gen, (20000,)),
    "normal": nrm.sample(gen, (20000,)),
    "gumbel": g.sample(gen, (20000,)),
    "lognormal": DistributionLognormal.new_from_mu_sig(3.0, 1.0).sample(
        gen, (20000,)),
}
samples = {k: v.cpu().numpy() for k, v in samples.items()}
for name, xs in samples.items():
    st = Statistics(xs.tolist())
    print(f"{name:10s} mean={st.mean:8.4f} std={st.std_dev:7.4f}")
assert abs(np.mean(samples["uniform"]) - 0.5) < 0.02
assert abs(np.mean(samples["normal"])) < 0.05
assert abs(np.mean(samples["gumbel"]) - 2.0) < 0.1
assert abs(np.mean(samples["lognormal"]) - 3.0) < 0.1

# ASCII histogram of the normal sample (stat_gumbel histogram style)
edges = np.linspace(-4.0, 4.0, 17).tolist()
h = Histogram(edges)
h.count(samples["normal"].tolist())
print(h)
counts = np.asarray(h.get_counts())
assert counts.sum() > 19000               # nearly all samples inside
assert counts.argmax() in (7, 8)          # mode at the center bins
print("ok")
