"""Normal distribution (mirrors russell_stat/examples/distribution_normal.rs).

Usage: python examples_torch/ex_stat_normal.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch

from russell_tpu_torch.stat import DistributionNormal, Histogram, Statistics

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

d = DistributionNormal(1.0, 0.5)
assert abs(float(d.pdf(1.0, device))
           - 1.0 / (0.5 * math.sqrt(2 * math.pi))) < 1e-12
assert abs(float(d.cdf(1.0, device)) - 0.5) < 1e-12
gen = torch.Generator(device=device).manual_seed(7)
s = d.sample(gen, (30000,)).cpu().numpy()
st = Statistics(s)
print(f"sampled mean {st.mean:.4f} std {st.std_dev:.4f}")
assert abs(st.mean - 1.0) < 0.02 and abs(st.std_dev - 0.5) < 0.02
h = Histogram(np.linspace(-1.0, 3.0, 17))
h.count(s)
h.set_bar_max_len(40)
print(h.draw())
print("normal OK")
