"""Chebyshev interpolation FROM DATA, including noisy data: adapt_data
picks the degree that stops improving, smoothing out the noise floor
(mirrors russell_lab examples/algo_interp_chebyshev_data.rs and
algo_interp_chebyshev_noisy_data.rs).

Usage: python examples_torch/ex_algo_interp_chebyshev_data.py
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


def f(x):
    return np.cos(3.0 * x) * np.exp(-0.5 * x)


# clean data at Chebyshev-Lobatto points: near machine-precision fit
interp = InterpChebyshev(30, xa, xb)
tol = 1e-8
interp.adapt_data(tol, [float(f(x)) for x in interp.points(30)])
nn_clean = interp.get_degree()
xs = np.linspace(xa, xb, 101)
err_clean = max(abs(float(interp.eval(x, device=device)) - f(x)) for x in xs)
print(f"clean data: degree={nn_clean} max_err={err_clean:.3e}")
assert err_clean < 1e-6

# noisy data: the adapted degree stays LOW (no noise chasing) and the
# fit error is bounded by the noise amplitude
rng = np.random.default_rng(1)
noise = 1e-3
interp2 = InterpChebyshev(30, xa, xb)
data = [float(f(x)) + noise * float(rng.normal())
        for x in interp2.points(30)]
interp2.adapt_data(2.0 * noise, data)
nn_noisy = interp2.get_degree()
err_noisy = max(abs(float(interp2.eval(x, device=device)) - f(x)) for x in xs)
print(f"noisy data: degree={nn_noisy} max_err={err_noisy:.3e}")
assert nn_noisy <= nn_clean
assert err_noisy < 50 * noise
print("chebyshev data interpolation OK")
