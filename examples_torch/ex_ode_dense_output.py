"""DoPri5 with dense output at fixed stations (mirrors
russell_ode examples/simple_ode_single_equation.rs + dense output).

Usage: python examples_torch/ex_ode_dense_output.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args, y_fn = samples.hairer_wanner_eq1()
solver = OdeSolver(Params(Method.DOPRI5), system, device)
out = Output().set_dense_h_out(0.1).set_dense_recording([0])
solver.solve(y0, x0, 1.5, args=args, output=out)
for x, y in zip(out.dense_x(), out.dense_y(0)):
    exact = float(y_fn(x, None)[0])
    print(f"x = {x:4.1f}  y = {y:20.12e}  err = {abs(y - exact):.1e}")
    assert abs(y - exact) < 1e-4
print("ok")
