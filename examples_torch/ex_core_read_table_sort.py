"""Base utilities: read a whitespace table from disk, sort small tuples,
and format numbers the Fortran way (mirrors russell_lab
examples/base_read_table.rs, base_sort_small_tuples.rs).

Usage: python examples_torch/ex_core_read_table_sort.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tempfile

from russell_tpu_torch.core import (format_fortran, read_table, sort2, sort3,
                                    sort4)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "table.txt")
    with open(path, "w") as fh:
        fh.write("time  force  displacement\n")
        fh.write("0.0   0.0    0.00\n")
        fh.write("1.0  12.5    0.25\n")
        fh.write("2.0  25.0    0.50\n")
    table = read_table(path, labels=["time", "force", "displacement"])
    print("columns:", sorted(table.keys()))
    assert list(table["force"]) == [0.0, 12.5, 25.0]

print("sort2(3,1) ->", sort2(3.0, 1.0))
assert sort2(3.0, 1.0) == (1.0, 3.0)
assert sort3(3.0, 1.0, 2.0) == (1.0, 2.0, 3.0)
assert sort4(4.0, 3.0, 1.0, 2.0) == (1.0, 2.0, 3.0, 4.0)
print("format_fortran(1234.5678) ->", format_fortran(1234.5678))
assert format_fortran(0.0).strip() == "0.000000000000000E+00"
print("ok")
