"""Gumbel distribution: pdf/cdf/moments + sampling histogram (mirrors
russell_stat/examples/distribution_gumbel.rs).

Usage: python examples_torch/ex_stat_gumbel.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.stat import DistributionGumbel, Histogram, Statistics

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

d = DistributionGumbel(8.782275, 11.938204)
xs = np.linspace(-20.0, 60.0, 9)
print(f"{'x':>8} {'pdf':>12} {'cdf':>12}")
for x in xs:
    print(f"{x:8.2f} {float(d.pdf(x, device)):12.6f} "
          f"{float(d.cdf(x, device)):12.6f}")
mu, var = float(d.mean()), float(d.variance())

gen = torch.Generator(device=device).manual_seed(4)
samples = d.sample(gen, (20000,)).cpu().numpy()
st = Statistics(samples)
print(f"mean {mu:.3f} (sampled {st.mean:.3f}), std {np.sqrt(var):.3f} "
      f"(sampled {st.std_dev:.3f})")
assert abs(st.mean - mu) < 0.5
assert abs(st.std_dev - np.sqrt(var)) < 0.5
h = Histogram(np.linspace(-20, 80, 11))
h.count(samples)
h.set_bar_max_len(30)
print(h.draw())
print("gumbel OK")
