"""Numerical test assertions ("check" mini-framework).

Mirrors the contract of ``russell_lab/src/check`` (approx_eq.rs,
array_approx_eq.rs, deriv1_approx_eq.rs, deriv2_approx_eq.rs,
assert_alike.rs): assertions raise ``AssertionError`` when values are NaN,
infinite, or differ by more than an absolute tolerance; derivative checkers
validate analytical derivatives against high-order finite differences.

Counterpart of ``russell_tpu.core.check``, copied: host numpy, as in the
reference. All helpers accept Python scalars, NumPy arrays and torch
tensors on any device (values are brought to the host: these are
test-time utilities).
"""

from __future__ import annotations

import numpy as np

from russell_tpu_torch.core._place import host as _host

__all__ = [
    "approx_eq",
    "array_approx_eq",
    "assert_alike",
    "complex_approx_eq",
    "complex_array_approx_eq",
    "deriv1_approx_eq",
    "deriv1_approx_eq_fw",
    "deriv1_approx_eq_bw",
    "deriv2_approx_eq",
    "deriv1_central5",
    "deriv1_forward4",
    "deriv1_backward4",
    "deriv2_central5",
]


def _scalar(x) -> float:
    return float(_host(x))


def approx_eq(a, b, tol: float) -> None:
    """Assert |a - b| <= tol; reject NaN/Inf (russell_lab check/approx_eq.rs:41)."""
    aa, bb = _scalar(a), _scalar(b)
    if np.isnan(aa):
        raise AssertionError("the first number is NaN")
    if np.isnan(bb):
        raise AssertionError("the second number is NaN")
    if np.isinf(aa):
        raise AssertionError("the first number is Inf")
    if np.isinf(bb):
        raise AssertionError("the second number is Inf")
    diff = abs(aa - bb)
    if diff > tol:
        raise AssertionError(f"numbers are not approximately equal. diff = {diff}")


def complex_approx_eq(a, b, tol: float) -> None:
    """Assert both real and imaginary parts are approximately equal."""
    aa, bb = complex(_host(a)), complex(_host(b))
    approx_eq(aa.real, bb.real, tol)
    approx_eq(aa.imag, bb.imag, tol)


def array_approx_eq(u, v, tol: float) -> None:
    """Assert two arrays are elementwise approximately equal (same shape)."""
    uu = np.asarray(_host(u), dtype=np.float64)
    vv = np.asarray(_host(v), dtype=np.float64)
    if uu.shape != vv.shape:
        raise AssertionError(f"arrays have different shapes: {uu.shape} vs {vv.shape}")
    if np.isnan(uu).any() or np.isnan(vv).any():
        raise AssertionError("NaN found in array")
    if np.isinf(uu).any() or np.isinf(vv).any():
        raise AssertionError("Inf found in array")
    diff = np.abs(uu - vv)
    if diff.size and diff.max() > tol:
        idx = np.unravel_index(int(np.argmax(diff)), diff.shape)
        raise AssertionError(
            f"arrays are not approximately equal. max diff = {diff.max()} at {idx} "
            f"({uu[idx]} vs {vv[idx]})"
        )


def complex_array_approx_eq(u, v, tol: float) -> None:
    uu = np.asarray(_host(u), dtype=np.complex128)
    vv = np.asarray(_host(v), dtype=np.complex128)
    array_approx_eq(uu.real, vv.real, tol)
    array_approx_eq(uu.imag, vv.imag, tol)


def assert_alike(a, b, rel_tol: float = 1e-15) -> None:
    """Assert equality modulo tiny relative error, treating NaN==NaN and
    Inf==Inf as alike (russell_lab check/assert_alike.rs)."""
    aa, bb = _scalar(a), _scalar(b)
    if np.isnan(aa) and np.isnan(bb):
        return
    if np.isinf(aa) and np.isinf(bb) and np.sign(aa) == np.sign(bb):
        return
    scale = max(abs(aa), abs(bb), 1.0)
    if abs(aa - bb) > rel_tol * scale:
        raise AssertionError(f"values are not alike: {aa} vs {bb}")


# ---------------------------------------------------------------------------
# finite-difference derivative approximations (5-point stencils)
# reference contract: russell_lab/src/check/{deriv1,deriv2}_approx_eq.rs and
# the num_deriv helpers they call
# ---------------------------------------------------------------------------

_STEP = 1e-3  # cube root of eps-ish scaled step used by 5-point formulas


def deriv1_central5(at_x: float, f, h: float = _STEP) -> float:
    """First derivative by 5-point central differences, O(h^4)."""
    x = float(at_x)
    fm2, fm1 = f(x - 2 * h), f(x - h)
    fp1, fp2 = f(x + h), f(x + 2 * h)
    return (fm2 - 8.0 * fm1 + 8.0 * fp1 - fp2) / (12.0 * h)


def deriv1_forward4(at_x: float, f, h: float = _STEP) -> float:
    """First derivative by 5-point forward differences, O(h^4)."""
    x = float(at_x)
    f0, f1, f2, f3, f4 = (f(x + i * h) for i in range(5))
    return (-25.0 * f0 + 48.0 * f1 - 36.0 * f2 + 16.0 * f3 - 3.0 * f4) / (12.0 * h)


def deriv1_backward4(at_x: float, f, h: float = _STEP) -> float:
    """First derivative by 5-point backward differences, O(h^4)."""
    x = float(at_x)
    f0, f1, f2, f3, f4 = (f(x - i * h) for i in range(5))
    return (25.0 * f0 - 48.0 * f1 + 36.0 * f2 - 16.0 * f3 + 3.0 * f4) / (12.0 * h)


def deriv2_central5(at_x: float, f, h: float = _STEP) -> float:
    """Second derivative by 5-point central differences, O(h^4)."""
    x = float(at_x)
    fm2, fm1, f0 = f(x - 2 * h), f(x - h), f(x)
    fp1, fp2 = f(x + h), f(x + 2 * h)
    return (-fm2 + 16.0 * fm1 - 30.0 * f0 + 16.0 * fp1 - fp2) / (12.0 * h * h)


def _check_deriv(dval: float, dnum: float, tol: float, what: str) -> None:
    if np.isnan(dval):
        raise AssertionError(f"the {what} is NaN")
    if np.isinf(dval):
        raise AssertionError(f"the {what} is Inf")
    if np.isnan(dnum):
        raise AssertionError(f"the numerical {what} is NaN")
    if np.isinf(dnum):
        raise AssertionError(f"the numerical {what} is Inf")
    diff = abs(dval - dnum)
    if diff > tol:
        raise AssertionError(
            f"{what} is not approximately equal to numerical value. diff = {diff}"
        )


def deriv1_approx_eq(dfdx, at_x: float, tol: float, f) -> None:
    """Assert analytical 1st derivative matches central 5-point differences."""
    _check_deriv(_scalar(dfdx), deriv1_central5(at_x, f), tol, "derivative")


def deriv1_approx_eq_fw(dfdx, at_x: float, tol: float, f) -> None:
    _check_deriv(_scalar(dfdx), deriv1_forward4(at_x, f), tol, "derivative")


def deriv1_approx_eq_bw(dfdx, at_x: float, tol: float, f) -> None:
    _check_deriv(_scalar(dfdx), deriv1_backward4(at_x, f), tol, "derivative")


def deriv2_approx_eq(d2fdx2, at_x: float, tol: float, f) -> None:
    """Assert analytical 2nd derivative matches central 5-point differences."""
    _check_deriv(_scalar(d2fdx2), deriv2_central5(at_x, f), tol, "second derivative")
