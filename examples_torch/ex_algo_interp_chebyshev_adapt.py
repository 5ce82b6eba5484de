"""Adaptive Chebyshev interpolation: automatic degree selection for a
smooth function, for clean discrete data, and for noisy data (mirrors
russell_lab examples/algo_interp_chebyshev_adapt.rs, _data.rs,
_noisy_data.rs).

Usage: python examples_torch/ex_algo_interp_chebyshev_adapt.py
       [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.algo import InterpChebyshev

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

xa, xb = -1.0, 1.0


def f(x, _):
    return np.cos(8.0 * (x + 1.0)) * (x + 1.01)


# 1) adaptive degree from the function itself
interp = InterpChebyshev(200, xa, xb).adapt_function(1e-8, f)
print(f"adapt_function: degree N = {interp.nn}")
xs = np.linspace(xa, xb, 301)
err = max(abs(float(interp.eval(x, device=device)) - f(x, None)) for x in xs)
print(f"  max |interp - f| = {err:.2e}")
assert err < 1e-7

# 2) adaptive fit of discrete data sampled at Chebyshev-Gauss-Lobatto pts
nn_fit = 100
zz = np.cos(np.pi * np.arange(nn_fit + 1) / nn_fit)
xx = np.sort((xb + xa + (xb - xa) * zz) / 2.0)
uu = np.array([f(x, None) for x in xx])
interp2 = InterpChebyshev(nn_fit, xa, xb).adapt_data(1e-8, uu)
print(f"adapt_data: degree N = {interp2.nn}")
err2 = max(abs(float(interp2.eval(x, device=device)) - f(x, None))
           for x in xs)
assert err2 < 1e-6

# 3) noisy data: the adaptive fit stays LOW degree (it must not chase noise)
rng = np.random.default_rng(42)
uu_noisy = uu + 1e-3 * (2.0 * rng.random(len(uu)) - 1.0)
interp3 = InterpChebyshev(nn_fit, xa, xb).adapt_data(2e-3, uu_noisy)
print(f"adapt_data (noisy): degree N = {interp3.nn}")
assert interp3.nn <= interp2.nn + 4
err3 = max(abs(float(interp3.eval(x, device=device)) - f(x, None))
           for x in xs)
print(f"  max |interp - f| = {err3:.2e}")
assert err3 < 5e-2
print("ok")
