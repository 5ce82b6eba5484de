"""1-D Bratu problem: spectral collocation + pseudo-arclength through
the fold, then extended-system Newton polish of the critical lambda
(mirrors russell_nonlin/tests/test_bratu_problem.rs; Mathematica oracle
lambda_crit = 3.51383071912516).

Usage: python examples_torch/ex_nonlin_bratu_fold.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

from russell_tpu_torch.nonlin import (Config, DeltaLambda, IniDir, Method,
                                      Output, Solver, Stop, samples)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

system, u0, l0, mid = samples.bratu_1d_spc(20, alpha=0.0)
sol = Solver(Config(method=Method.ARCLENGTH), system, device)
out = Output().set_recording(list(range(system.ndim)))
_u, _l, status = sol.solve(u0, l0, IniDir.POS, Stop.max_comp_u(mid, 20.0),
                           DeltaLambda.auto(0.5), output=out)
assert status.success()
ls = np.asarray(out.step_l)
um = np.asarray(out.step_u(mid))
print("path:  lambda  phi(1/2)")
for l, um_ in zip(ls, um):
    print(f"  {l:8.5f}  {um_:8.5f}")

# fold = the discrete maximum of lambda along the path, polished by
# Newton on [G; Gu v; v_k - 1] = 0
j = int(np.argmax(ls))
n = system.ndim
uj = np.stack([out.step_u(m) for m in range(n)], axis=1)[j]


def gu_mat(l, u):
    vals, _ = system.calc_jac(l, u, None)
    return torch.reshape(vals, (n, n))


ut = torch.as_tensor(uj, device=device)
w, vv = np.linalg.eig(gu_mat(float(ls[j]), ut).cpu().numpy())
v = np.real(vv[:, np.argmin(np.abs(w))])
k = int(np.argmax(np.abs(v)))
z = torch.cat([ut, torch.as_tensor(v / v[k], device=device),
               torch.as_tensor([ls[j]], dtype=torch.float64,
                               device=device)])


def ff(z):
    u, v, l = z[:n], z[n:2 * n], z[2 * n]
    return torch.cat([system.calc_gg(l, u, None), gu_mat(l, u) @ v,
                      (v[k] - 1.0)[None]])


for _ in range(30):
    dz = torch.linalg.solve(torch.func.jacfwd(ff)(z), -ff(z))
    z = z + dz
    if float(torch.max(torch.abs(dz))) < 1e-12:
        break
lam_crit = float(z[2 * n])
print(f"lambda_crit = {lam_crit:.12f} (Mathematica: 3.513830719125)")
assert abs(lam_crit - 3.51383071912516) < 1e-9
print("ok")
