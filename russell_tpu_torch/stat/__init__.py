"""Statistics and probability distributions.

Counterpart of ``russell_tpu.stat`` (reference surface: russell_stat/src/):
distributions over the ProbabilityDistribution contract
(pdf/cdf/mean/variance/sample), whose ``pdf`` and ``cdf`` follow the
device rule of ``core/_place.py`` and whose ``sample`` draws on an
explicit ``torch.Generator``'s device; descriptive statistics,
quantiles/quartiles/IQR/outliers and the text histogram on the host, as
in the reference.
"""

from russell_tpu_torch.stat.distributions import (
    ProbabilityDistribution, DistributionFrechet, DistributionGumbel,
    DistributionLognormal, DistributionNormal, DistributionUniform)
from russell_tpu_torch.stat.statistics import (Statistics, quantile,
                                               quartiles,
                                               inter_quartile_range, outliers)
from russell_tpu_torch.stat.histogram import Histogram

__all__ = [
    "ProbabilityDistribution", "DistributionFrechet", "DistributionGumbel",
    "DistributionLognormal", "DistributionNormal", "DistributionUniform",
    "Statistics", "quantile", "quartiles", "inter_quartile_range",
    "outliers", "Histogram",
]
