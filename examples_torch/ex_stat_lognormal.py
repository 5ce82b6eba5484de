"""Lognormal distribution: pdf/cdf/moments + sampling (mirrors
russell_stat/examples/distribution_lognormal.rs).

Usage: python examples_torch/ex_stat_lognormal.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch
from scipy.stats import lognorm

from russell_tpu_torch.stat import DistributionLognormal, Statistics

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

d = DistributionLognormal(0.0, 0.25)
xs = np.linspace(0.2, 3.0, 8)
print(f"{'x':>6} {'pdf':>12} {'cdf':>12}")
for x in xs:
    p, c = float(d.pdf(x, device)), float(d.cdf(x, device))
    print(f"{x:6.2f} {p:12.6f} {c:12.6f}")
    # oracle: scipy lognorm with s=0.25, scale=e^0
    assert abs(p - lognorm.pdf(x, 0.25)) < 1e-12
    assert abs(c - lognorm.cdf(x, 0.25)) < 1e-12
mu, var = float(d.mean()), float(d.variance())
assert abs(mu - math.exp(0.25 ** 2 / 2)) < 1e-12

gen = torch.Generator(device=device).manual_seed(1)
s = d.sample(gen, (20000,)).cpu().numpy()
st = Statistics(s)
print(f"mean {mu:.4f} sampled {st.mean:.4f}; std {math.sqrt(var):.4f} "
      f"sampled {st.std_dev:.4f}")
assert abs(st.mean - mu) < 0.02
print("lognormal OK")
