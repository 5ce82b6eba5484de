"""Stiffness detection (reference: russell_ode/src/detect_stiffness.rs:5-27).

Counterpart of ``russell_tpu.ode.detect_stiffness``; host-side control on
plain floats. h·ρ (ρ ≈ |dominant eigenvalue| of J, Hairer-Wanner II p.22)
is compared to a method-specific stability-boundary value; detections
must be ratified over several steps and are reset after enough negative
steps.
"""

from __future__ import annotations

__all__ = ["detect_stiffness", "StiffnessError"]


class StiffnessError(RuntimeError):
    pass


def detect_stiffness(work, x: float, params) -> None:
    work.stiff_detected = False
    if work.stats.n_accepted <= params.stiffness.skip_first_n_accepted_step:
        return
    if work.stiff_h_times_rho > params.stiffness.h_times_rho_max:
        work.stiff_x_first_detect = min(x, work.stiff_x_first_detect)
        work.stiff_n_detection_no = 0
        work.stiff_n_detection_yes += 1
        if work.stiff_n_detection_yes == params.stiffness.ratified_after_nstep:
            work.stiff_detected = True
            if params.stiffness.stop_with_error:
                raise StiffnessError("stiffness detected")
    else:
        work.stiff_n_detection_no += 1
        if work.stiff_n_detection_no == params.stiffness.ignored_after_nstep:
            work.stiff_x_first_detect = float("inf")
            work.stiff_n_detection_yes = 0
