#!/usr/bin/env python3
"""Variants of the Jacobi eigensolver kernel timed on one NVIDIA GPU: where
the time of ``russell_tpu_torch/csrc/jacobi_eig.cu`` goes.

Each variant is the kernel's source with a few lines replaced, compiled by
nvcc (``kernel_variants.py``) and launched through the same C entry point,
on the route ``dense.matrix_ops._jacobi_route`` picks, with
``chip_smoke.lab_sym(n, n)`` at each n of SIZES (n 256 also forced onto
the global-scratch route, n 128 and 256 also on a cluster of 8 CTAs, the
portable size, against the wrapper's 16). After one second of f64 GEMMs
that wakes the card's clocks, it prints one JSON line per (variant, n): the device
time of one call back to back (``chip_smoke.time_ms``), ns a round (30
sweeps of n - 1 rounds, n even), the share of the bound
(``chip_smoke.jacobi_work``) and whether w and V have the plain version's
bits (``_jacobi_eig_plain`` run on the card once per n). ``final`` is the
kernel as it is. The diagnostic variants give other bits by design and
split the time of a round: ``no_rotation`` (c, s from the loaded entries
without the divisions and square roots), ``no_vt`` (V^T's rows left out),
``no_blocks`` (A's blocks left out), ``no_push`` (each CTA writes its
(c, s) into its own table only), ``cta_barriers`` (a round's cluster
barriers replaced by the CTA's: the CTAs run unsynchronised), ``no_barriers``
(a round's barriers all left out), ``no_overlap`` (V^T's rows after the
cluster barrier's wait, not between its arrive and wait) and
``chain_only`` (no_vt and no_blocks: the rotations and the barriers
alone). The final cluster barrier stays in every variant, so that no CTA
leaves while another reads its shared memory.
``--only a,b`` runs the variants named; ``--source name=path`` adds a
whole other source file as a variant (an earlier version of the kernel,
with the same C entry point). Run from the repository root:

    python3 jacobi_variants.py
"""

from __future__ import annotations

import json

import torch

import chip_smoke as cs
import kernel_variants as kv
from russell_tpu_torch.dense import matrix_ops
from russell_tpu_torch.sparse import _cuda

# (n, route forced by lowered budgets or None, CTAs of the cluster or None
# for the wrapper's)
SIZES = ((32, None, None), (128, None, None), (256, None, None),
         (256, "global", None), (128, None, 8), (256, None, 8))

_NO_VT = ("for (int k = iv.k, j = iv.j; k < S;) {",
          "for (int k = S, j = 0; k < S;) {")
_NO_BLOCKS = ("for (int k = ia.k, J = ia.j; k < S;) {",
              "for (int k = S, J = 0; k < S;) {")
_ARRIVE = 'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");'
_NO_ARRIVE = (_ARRIVE, "")
_NO_WAIT = ('asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");',
            "")
# the cluster's barrier at the end of a round as the CTA's
_ROUND_END = ("seats->advance();  // read again after the barrier\n"
              "    barrier<kCluster>();",
              "seats->advance();  // read again after the barrier\n"
              "    __syncthreads();")
# name: [(text of the kernel source, its replacement)]
VARIANTS = {
    "final": [],
    "no_rotation": [(
        "rotation(sl.p_src[sl.q], sl.p_src[sl.p], sl.q_src[sl.q], cc, ss);",
        "cc = 1.0 + 0.0 * sl.p_src[sl.q] * sl.p_src[sl.p];\n"
        "        ss = 0.0 * sl.q_src[sl.q];")],
    "no_vt": [_NO_VT],
    "no_blocks": [_NO_BLOCKS],
    "no_push": [("for (int d = 0; d < g.C; ++d) {",
                 "for (int d = c; d <= c; ++d) {")],
    "cta_barriers": [_ROUND_END, _NO_ARRIVE, _NO_WAIT],
    "no_barriers": [_ROUND_END, _NO_ARRIVE, _NO_WAIT,
                    ("    __syncthreads();\n    for (int k = iv.k",
                     "    for (int k = iv.k"),
                    ("    __syncthreads();\n  }\n\n  // w and V",
                     "  }\n\n  // w and V")],
    "no_overlap": [_NO_ARRIVE, (_NO_WAIT[0], _ARRIVE + "\n      " +
                                _NO_WAIT[0])],
    "chain_only": [_NO_VT, _NO_BLOCKS],
}
EXACT = ("final",)


def main():
    fns = kv.start("jacobi_eig", "jacobi_eig_f64", VARIANTS)
    sweeps = matrix_ops.JACOBI_SWEEPS
    plain = {}
    for n, forced, ctas in SIZES:
        A = torch.as_tensor(cs.lab_sym(n, n), device="cuda")
        if n not in plain:
            plain[n] = matrix_ops._jacobi_eig_plain(A, sweeps)
        want = plain[n]
        route, cluster, shared, work_doubles = cs.jacobi_forced(
            forced or "cta", lambda: matrix_ops._jacobi_route(n), ctas)
        work = torch.empty(max(work_doubles, 1), dtype=A.dtype,
                           device="cuda")
        nb, fl, from_code = cs.jacobi_work(n, sweeps, route)
        rounds = from_code["rounds"]
        b_ms = cs.bound(nb, fl)[0]
        for name, (fn, _) in fns.items():
            w = torch.empty(n, dtype=A.dtype, device="cuda")
            V = torch.empty((n, n), dtype=A.dtype, device="cuda")

            def launch(fn=fn, w=w, V=V):
                _cuda.launch_check(name, fn(
                    A.data_ptr(), n, sweeps, cluster, int(shared),
                    work.data_ptr() if work_doubles else None, work_doubles,
                    w.data_ptr(), V.data_ptr(), _cuda.stream_of(A)))
            launch()
            torch.cuda.synchronize()
            same = torch.equal(w, want[0]) and torch.equal(V, want[1])
            ms = cs.time_ms(launch, reps=5, warmup=2)
            print(json.dumps({"variant": name, "n": n, "route": route,
                              "cluster": cluster, "ms": ms,
                              "ns_per_round": 1e6 * ms / rounds,
                              "share": b_ms / ms, "bit_identical": same}),
                  flush=True)
            if (name in EXACT or name not in VARIANTS) and not same:
                raise AssertionError(f"{name} at n {n} ({route}): other "
                                     "bits")
    cs.say("clocks_after", nvidia_smi=kv.clocks())


if __name__ == "__main__":
    main()
