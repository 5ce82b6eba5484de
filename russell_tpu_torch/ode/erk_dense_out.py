"""Dense output for DoPri5 / DoPri8, in PyTorch (reference:
russell_ode/src/erk_dense_out.rs).

Counterpart of ``russell_tpu.ode.erk_dense_out``. DoPri5: 5 interpolation
vectors built from the accepted stages (no extra function evaluations).
DoPri8: 8 vectors requiring 3 extra stages (dop853.f's a14-a16 rows).
The vectors are computed on the stages' device, with the reference's
operations in its order.
"""

from __future__ import annotations

import torch

from russell_tpu_torch.ode import constants as C
from russell_tpu_torch.ode.enums import Method

__all__ = ["ErkDenseOut"]


class ErkDenseOut:
    def __init__(self, method: Method, ndim: int, system):
        if method not in (Method.DOPRI5, Method.DOPRI8):
            raise ValueError(
                f"dense output is not available for the {method.name} method")
        self.method = method
        self.ndim = ndim
        self.system = system
        self.d = None  # (5 or 8, ndim) interpolation vectors

    def _dopri5(self, y, h, w, k):
        dd = C.DOPRI5_D.tolist()
        y_diff = w - y
        b_spl = h * k[0] - y_diff
        d4 = h * (dd[0] * k[0] + dd[2] * k[2] + dd[3] * k[3]
                  + dd[4] * k[4] + dd[5] * k[5] + dd[6] * k[6])
        return torch.stack([y, y_diff, b_spl, y_diff - h * k[6] - b_spl, d4])

    def _dopri8(self, x, y, h, w, k, args):
        f = self.system.function
        dd, aad, ccd = (C.DOPRI8_D.tolist(), C.DOPRI8_AD.tolist(),
                        C.DOPRI8_CD.tolist())

        def comb(row, kd_list):
            # column 12 multiplies k[11] again (dop853's 13th stage is
            # FSAL); columns 13.. multiply the extra stages
            acc = torch.zeros_like(y)
            for j in range(12):
                if row[j] != 0.0:
                    acc = acc + row[j] * k[j]
            if row[12] != 0.0:
                acc = acc + row[12] * k[11]
            for extra, kd in enumerate(kd_list):
                if row[13 + extra] != 0.0:
                    acc = acc + row[13 + extra] * kd
            return acc

        kd = []
        for s in range(3):
            yd = y + h * comb(aad[s], kd)
            kd.append(f(x + ccd[s] * h, yd, args))

        y_diff = w - y
        b_spl = h * k[0] - y_diff
        d3 = y_diff - h * k[11] - b_spl
        drows = [h * comb(dd[r], kd) for r in range(4)]
        return torch.stack([y, y_diff, b_spl, d3] + drows)

    def update(self, x, y, h, w, k, args) -> int:
        """Store interpolation vectors; returns extra function-eval count."""
        if self.method == Method.DOPRI5:
            self.d = self._dopri5(y, h, w, k)
            return 0
        self.d = self._dopri8(x, y, h, w, k, args)
        return 3

    def calculate(self, x_out, x, h):
        d = self.d
        theta = (x_out - (x - h)) / h
        u = 1.0 - theta
        if self.method == Method.DOPRI5:
            return d[0] + theta * (d[1] + u * (d[2] + theta * (d[3] + u * d[4])))
        par = d[4] + theta * (d[5] + u * (d[6] + theta * d[7]))
        return d[0] + theta * (d[1] + u * (d[2] + theta * (d[3] + u * par)))
