"""Uniform distribution (mirrors
russell_stat/examples/distribution_uniform.rs).

Usage: python examples_torch/ex_stat_uniform.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

from russell_tpu_torch.stat import DistributionUniform, Statistics

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

a, b = 2.0, 5.0
d = DistributionUniform(a, b)
assert float(d.pdf(3.0, device)) == 1.0 / (b - a)
assert float(d.pdf(1.0, device)) == 0.0
assert abs(float(d.cdf(3.5, device)) - 0.5) < 1e-12
assert float(d.mean()) == 3.5
assert abs(float(d.variance()) - (b - a) ** 2 / 12.0) < 1e-12
gen = torch.Generator(device=device).manual_seed(3)
s = d.sample(gen, (20000,)).cpu().numpy()
st = Statistics(s)
print(f"sampled: min {st.min:.3f} max {st.max:.3f} mean {st.mean:.3f}")
assert st.min >= a and st.max <= b and abs(st.mean - 3.5) < 0.03
print("uniform OK")
