"""Mathematical constants (reference: russell_lab/src/math/constants.rs:99).

Counterpart of ``russell_tpu.math.constants``, copied."""

import math

PI = math.pi
SQRT_PI = math.sqrt(math.pi)
NAPIER = math.e
EULER = 0.5772156649015328606065120900824024310421593359399
SQRT_2 = math.sqrt(2.0)
SQRT_3 = math.sqrt(3.0)
SQRT_6 = math.sqrt(6.0)
SQRT_2_BY_3 = math.sqrt(2.0 / 3.0)
SQRT_3_BY_2 = math.sqrt(3.0 / 2.0)
ONE_BY_3 = 1.0 / 3.0
TWO_BY_3 = 2.0 / 3.0
ONE_BY_SQRT_2 = 1.0 / math.sqrt(2.0)
COS_PI_BY_8 = math.cos(math.pi / 8.0)
SIN_PI_BY_8 = math.sin(math.pi / 8.0)
LN2 = math.log(2.0)
LN10 = math.log(10.0)
SQRT_EPSILON = 1.490116119384765625e-8
GOLDEN_RATIO = (1.0 + math.sqrt(5.0)) / 2.0
