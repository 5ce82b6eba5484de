"""Special mathematical functions, in PyTorch (counterpart of
``russell_tpu.math``; reference: russell_lab/src/math/).

Bessel (J/Y/I/K), gamma/beta, erf and its inverses, elliptic integrals
(Legendre forms through Carlson's symmetric forms), Chebyshev and Legendre
polynomials and their point sets, composition functions, float helpers
and the constants table. The elementwise functions follow the device rule
of ``core/_place.py``: a tensor computes on its own device, a float, list
or numpy array on ``device=`` (the card by default). The point and weight
sets, ``factorial_lookup_22`` and the float and complex helpers are host
numpy and Python, as in the reference.
"""

from russell_tpu_torch.math.bessel import (
    bessel_j0, bessel_j1, bessel_jn, bessel_y0, bessel_y1, bessel_yn,
    bessel_i0, bessel_i1, bessel_in, bessel_k0, bessel_k1, bessel_kn)
from russell_tpu_torch.math.basic import (
    gamma, ln_gamma, beta, ln_beta, factorial_lookup_22,
    erf, erfc, erf_inv, erfc_inv,
    neg_one_pow_n, sign, ramp, heaviside, boxcar, logistic, logistic_deriv1,
    smooth_ramp, smooth_ramp_deriv1, smooth_ramp_deriv2, suq_sin, suq_cos,
    float_is_integer, float_is_neg_integer, float_split, float_decompose,
    float_compose, modulo, i_pow_n, x_times_i_pow_n)
from russell_tpu_torch.math.elliptic import (
    elliptic_f, elliptic_e, elliptic_pi,
    carlson_rf, carlson_rd, carlson_rj, carlson_rc)
from russell_tpu_torch.math.chebyshev import (
    chebyshev_tn, chebyshev_tn_deriv1, chebyshev_tn_deriv2,
    chebyshev_un, chebyshev_un_deriv1, chebyshev_un_deriv2,
    chebyshev_gauss_points, chebyshev_lobatto_points)
from russell_tpu_torch.math.legendre import (
    legendre_pn, legendre_pn_deriv1, legendre_pn_deriv2,
    legendre_gauss_points, legendre_gauss_weights,
    legendre_lobatto_points, legendre_lobatto_weights)
from russell_tpu_torch.math import constants
from russell_tpu_torch.math.constants import (
    PI, SQRT_PI, NAPIER, EULER, SQRT_2, SQRT_3, SQRT_6, SQRT_2_BY_3,
    SQRT_3_BY_2, ONE_BY_3, TWO_BY_3, ONE_BY_SQRT_2, COS_PI_BY_8, SIN_PI_BY_8,
    LN2, LN10, SQRT_EPSILON, GOLDEN_RATIO)
