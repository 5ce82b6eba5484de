"""Core utilities tour: Stopwatch, Fortran/scientific formatting, grid
generators, small-tuple sorting and peak finding (mirrors russell_lab
examples/base_sort_small_tuples.rs + the base doc surface).

Usage: python examples_torch/ex_core_utilities.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from russell_tpu_torch.core import (Stopwatch, find_valleys_and_peaks,
                                    format_fortran, format_nanoseconds,
                                    format_scientific, generate2d, generate3d,
                                    linspace, sort2, sort3, sort4)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

# Stopwatch (profiling primitive wired into LinSolver/ODE stats)
sw = Stopwatch()
time.sleep(0.01)
ns = sw.stop()
assert ns >= 10_000_000
print("elapsed:", format_nanoseconds(ns))

# Fortran-style (ES23.15 field) and scientific formatting oracles
assert format_fortran(1234.5678).strip() == "1.234567800000000E+03"
assert format_scientific(0.0001234, 10, 3).strip() == "1.234E-04"

# sort2/sort3/sort4 return ascending tuples
assert sort2(3.0, 1.0) == (1.0, 3.0)
assert sort3(3.0, 1.0, 2.0) == (1.0, 2.0, 3.0)
assert sort4(4.0, 3.0, 1.0, 2.0) == (1.0, 2.0, 3.0, 4.0)

# meshgrid generators (plotting/PDE setup helpers)
X, Y = generate2d(0.0, 1.0, 0.0, 2.0, 3, 5, device=device)
assert X.shape == (5, 3) and float(Y[-1, 0]) == 2.0
X3, Y3, Z3 = generate3d(0, 1, 0, 1, 0, 1, 2, 2, 2, device=device)
assert X3.shape == (2, 2, 2)
xs = linspace(0.0, 1.0, 11, device=device).cpu().numpy()
assert abs(xs[5] - 0.5) < 1e-15

# peaks/valleys of a sampled sine wave: (valley indices, peak indices)
t = np.linspace(0.0, 4.0 * np.pi, 401)
valleys, peaks = find_valleys_and_peaks(np.sin(t).tolist())
assert peaks == [50, 250] and valleys == [150, 350]
print("peaks found at sample indices:", peaks)
print("core utilities OK")
