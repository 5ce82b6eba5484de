"""Dense output through the FUSED Radau5 device loop: stations are
carried as a static buffer through the captured step loop and filled
from the collocation polynomial on the device, identical values to the
host path (mirrors russell_ode dense output contract, radau5.rs:669 /
output.rs:269-285, inside the production fast path).

Usage: python examples_torch/ex_ode_fused_dense_output.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args, _y_ref = samples.brusselator_ode()
params = Params(Method.RADAU5)
params.set_tolerances(1e-6, 1e-6)

# host-stepped reference
out_host = Output().set_dense_h_out(0.5).set_dense_recording([0, 1])
yh = OdeSolver(params, system, device).solve(y0, x0, 10.0, args=args,
                                             output=out_host)
# fused device loop with the same stations
out_fused = Output().set_dense_h_out(0.5).set_dense_recording([0, 1])
yf = OdeSolver(params, system, device).solve(y0, x0, 10.0, output=out_fused,
                                             fused=True)
assert out_fused.dense_x() == out_host.dense_x()
for m in (0, 1):
    np.testing.assert_allclose(out_fused.dense_y(m), out_host.dense_y(m),
                               rtol=0.0, atol=1e-12)
np.testing.assert_allclose(yf.cpu().numpy(), yh.cpu().numpy(), atol=1e-12)
for x, ya, yb in list(zip(out_fused.dense_x(), out_fused.dense_y(0),
                          out_fused.dense_y(1)))[:6]:
    print(f"x={x:5.2f}  y0={ya:10.6f}  y1={yb:10.6f}")
print(f"{len(out_fused.dense_x())} dense stations, fused == host")
print("fused dense output OK")
