"""Van der Pol (mildly stiff, eps=0.003) with DoPri5 and stiffness-aware
step statistics (mirrors russell_ode examples/van_der_pol_dopri5.rs,
the companion of the Radau5 van der Pol example).

Usage: python examples_torch/ex_ode_van_der_pol_dopri5.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from russell_tpu_torch.ode import Method, OdeSolver, Output, Params, samples

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, x0, y0, args, _ = samples.van_der_pol(0.003)
params = Params(Method.DOPRI5)
params.set_tolerances(1e-5, 1e-5)
out = Output().set_dense_h_out(0.2).set_dense_recording([0, 1])
solver = OdeSolver(params, system, device)
y = solver.solve(y0, x0, 2.0, args=args, output=out)
st = solver.stats()
print(f"steps={st.n_steps} accepted={st.n_accepted} "
      f"rejected={st.n_rejected} f_evals={st.n_function}")
for x, y0v in list(zip(out.dense_x(), out.dense_y(0)))[:6]:
    print(f"x={x:4.1f}  y0={y0v: .6f}")
# the limit cycle keeps |y0| near 2 over this horizon
yf = y.cpu().numpy()
assert 1.6 < abs(yf[0]) < 2.2, yf
assert st.n_accepted > 100        # mild stiffness makes DoPri5 work hard
assert st.n_rejected > 0
print("van der pol dopri5 OK")
