"""Adaptive Chebyshev interpolation of NOISY data (mirrors russell_lab
examples/algo_interp_chebyshev_noisy_data.rs): sample an oscillatory
generator on Chebyshev points, add alternating +/-0.1 noise, and let
``adapt_data`` pick the degree. Like the reference (adapt_data fits the
data exactly, then adapts against that fit: interp_chebyshev.rs:450),
the noise keeps the Chebyshev spectrum above tol so the full data degree
is kept; the interpolant still tracks the generator to within the
injected noise scale.

Usage: python examples_torch/ex_algo_interp_chebyshev_noisy.py
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

def generator(x):
    return np.cos(16.0 * (x + 0.2)) * (1.0 + x) * np.exp(x * x) \
        / (1.0 + 9.0 * x * x)


xa, xb = -1.0, 1.0
nn_fit = 30
zz = InterpChebyshev.points(nn_fit)
xx_dat = (xb + xa + (xb - xa) * np.asarray(zz)) / 2.0
dy = 0.1
noise = np.where(np.arange(nn_fit + 1) % 2 == 0, dy, -dy)
uu = generator(xx_dat) + noise

interp = InterpChebyshev(100, xa, xb)
interp.adapt_data(1e-8, uu)
nn = interp.get_degree()
print(f"adapted degree N = {nn}")
xx = np.linspace(xa, xb, 201)
err = max(abs(float(interp.eval(x, device=device)) - generator(x))
          for x in xx)
print(f"max |interp - generator| = {err:.4f}")
# the fit must track the generator to within the injected noise scale,
# not reproduce the +/-0.1 zigzag (which would need degree ~nn_fit)
assert nn <= nn_fit
assert err < 2.5 * dy
print("ok")
