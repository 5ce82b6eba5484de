"""Whitespace-table numeric reader (mirrors
russell_lab/examples/base_read_data.rs / base_read_table.rs).

Usage: python examples_torch/ex_core_read_data.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

import numpy as np

from russell_tpu_torch.core import read_data, read_table

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

txt = """# comment line
1.0  2.0   3.0
4.0  5.0   6.0
7.0  8.0   9.0
"""
with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as fh:
    fh.write(txt)
    path = fh.name
data = read_data(path)
assert data.shape == (3, 3) and data[1, 2] == 6.0

with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as fh:
    fh.write("x y z\n" + "\n".join("%g %g %g" % tuple(r) for r in data))
    tpath = fh.name
table = read_table(tpath)
assert list(table.keys()) == ["x", "y", "z"]
assert np.allclose(table["y"], [2.0, 5.0, 8.0])
os.unlink(path)
os.unlink(tpath)
print("rows:", data.shape[0], "cols:", data.shape[1])
print("read_data / read_table OK")
