"""Robertson stiff chemical kinetics via Radau5 with exact radau5.f
statistics (mirrors russell_ode/examples/robertson.rs and
tests/test_radau5_robertson.rs).

Usage: python examples_torch/ex_ode_robertson_radau5.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.ode import Method, OdeSolver, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args = samples.robertson()
params = Params(Method.RADAU5)
params.step.h_ini = 1e-6
params.set_tolerances(1e-8, 1e-2)
solver = OdeSolver(params, system, device)
y = solver.solve(y0, x0, 0.3, args=args)
st = solver.stats()
print(st.summary())
y = y.cpu().numpy()
# radau5.f oracle values + mass conservation y1+y2+y3 == 1
assert abs(float(y[0]) - 9.886740138499884e-01) < 1e-15
assert abs(float(y.sum()) - 1.0) < 1e-10
assert (st.n_function, st.n_jacobian, st.n_steps) == (88, 8, 17)
print("robertson final:", y)
print("ok")
