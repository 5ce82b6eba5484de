"""First- and second-derivative checkers: central/forward/backward
finite-difference stencils asserting analytic derivatives
(mirrors russell_lab examples/check_1st_and_2nd_derivatives.rs). The
checkers run on the host, as in the reference; ``--device`` is accepted
like every example's.

Usage: python examples_torch/ex_check_derivatives.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math

from russell_tpu_torch.core import (deriv1_approx_eq, deriv1_approx_eq_bw,
                                    deriv1_approx_eq_fw, deriv1_central5,
                                    deriv2_approx_eq, deriv2_central5)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# f(x) = sin(x) e^{-x/2}: check f' and f'' at several points


def f(x):
    return math.sin(x) * math.exp(-0.5 * x)


def df(x):
    return (math.cos(x) - 0.5 * math.sin(x)) * math.exp(-0.5 * x)


def ddf(x):
    return (-0.75 * math.sin(x) - math.cos(x)) * math.exp(-0.5 * x)


for x in (0.0, 0.8, 2.0, 3.5):
    deriv1_approx_eq(df(x), x, 1e-9, f)      # central 5-point
    deriv2_approx_eq(ddf(x), x, 1e-8, f)


# one-sided checks matter at domain edges: g(x) = sqrt(x) near 0
def g(x):
    return math.sqrt(x)


def dg(x):
    return 0.5 / math.sqrt(x)


deriv1_approx_eq_fw(dg(0.09), 0.09, 1e-4, g)   # forward from the left edge
deriv1_approx_eq_bw(dg(4.0), 4.0, 1e-6, g)     # backward from the right

# the raw stencil values are available too
d1 = deriv1_central5(1.2, f)
assert abs(d1 - df(1.2)) < 1e-10
d2 = deriv2_central5(1.2, f)
assert abs(d2 - ddf(1.2)) < 1e-8
print("f'(1.2) central5 =", d1, "analytic =", df(1.2))
print("derivative checks OK")
