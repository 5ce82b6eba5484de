"""Frechet extreme-value distribution + robust statistics: quartiles,
IQR, outlier detection and an ASCII histogram
(mirrors russell_stat examples/distribution_frechet.rs and the
statistics.rs quartiles/outliers doc surface).

Usage: python examples_torch/ex_stat_frechet_quartiles.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

import numpy as np
import torch

from russell_tpu_torch.stat import (DistributionFrechet, Histogram,
                                    inter_quartile_range, outliers, quantile,
                                    quartiles)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# Frechet(location=0, scale=1, shape=4): mean = Gamma(1 - 1/shape)
fr = DistributionFrechet(0.0, 1.0, 4.0)
assert abs(fr.mean() - math.gamma(1.0 - 0.25)) < 1e-12
# cdf(x) = exp(-x^-shape) for x > location
assert abs(float(fr.cdf(1.0, device)) - math.exp(-1.0)) < 1e-12
# pdf integrates to ~1 over a generous range (trapezoid check)
xs = np.linspace(1e-3, 40.0, 200001)
pdf = fr.pdf(xs, device).cpu().numpy()
assert abs(np.trapezoid(pdf, xs) - 1.0) < 1e-4

# sampling from an explicitly seeded generator
gen = torch.Generator(device=device).manual_seed(0)
samples = fr.sample(gen, (40000,)).cpu().numpy()
assert abs(np.mean(samples) - fr.mean()) < 0.05

# quartiles / IQR / outliers on a small dataset with a planted outlier
data = [2.0, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 30.0]
q1, q2, q3 = quartiles(data)
assert q1 <= q2 <= q3
assert abs(q2 - 4.5) < 1e-12
iqr = inter_quartile_range(data)
assert abs(iqr - (q3 - q1)) < 1e-12
out = outliers(data)
assert any(abs(v - 30.0) < 1e-12 for _i, v in out), out
assert abs(quantile(data, 0.5) - q2) < 1e-12

# histogram of the Frechet samples (text renderer)
h = Histogram(np.linspace(0.0, 5.0, 11).tolist())
h.count(samples.tolist())
print(h.draw())
print("median =", q2, "IQR =", iqr, "outliers =", out)
print("frechet/quartiles OK")
