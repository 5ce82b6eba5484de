"""Core utilities: check assertions, enums, stopwatch, formatters, generators.

Counterpart of ``russell_tpu.core`` (reference: russell_lab/src/base,
russell_lab/src/check). The check assertions, formatters, sorting, peak
finding and table readers are host Python and numpy, as in the
reference; the norms and the grid generators follow the device rule of
``core/_place.py``.
"""

import numpy as _np
import torch as _torch

from russell_tpu_torch.core._place import host as _host
from russell_tpu_torch.core.check import (
    approx_eq,
    array_approx_eq,
    assert_alike,
    complex_approx_eq,
    complex_array_approx_eq,
    deriv1_approx_eq,
    deriv1_approx_eq_fw,
    deriv1_approx_eq_bw,
    deriv2_approx_eq,
    deriv1_central5,
    deriv1_forward4,
    deriv1_backward4,
    deriv2_central5,
)
from russell_tpu_torch.core.enums import Norm
from russell_tpu_torch.core.stopwatch import Stopwatch, format_nanoseconds
from russell_tpu_torch.core.formatters import (
    format_fortran,
    format_scientific,
)
from russell_tpu_torch.core.generators import linspace, generate2d, generate3d
from russell_tpu_torch.core.sort import sort2, sort3, sort4
from russell_tpu_torch.core.read_table import read_table, read_data
from russell_tpu_torch.core.peaks import find_valleys_and_peaks


def fetch_host(x):
    """A tensor (any device; complex included) or array-like -> numpy on
    the host. Complex tensors come back as complex128 from their real and
    imaginary planes, as the reference fetches them."""
    if isinstance(x, _torch.Tensor) and x.is_complex():
        return (_host(x.real).astype(_np.float64)
                + 1j * _host(x.imag).astype(_np.float64))
    return _host(x)
