"""Probability distributions (reference: russell_stat/src/distribution_*.rs
over the trait probability_distribution.rs:4).

Counterpart of ``russell_tpu.stat.distributions``. ``pdf`` and ``cdf``
follow the device rule of ``core/_place.py``: given a tensor they compute
on its device, given anything else on ``device=`` (the card by default).
``mean`` and ``variance`` are host floats. ``sample(generator, shape)``
draws f64 values on the device of an explicit ``torch.Generator`` by the
reference's inverse transforms; the streams differ from ``jax.random``'s,
so the two packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import torch

from russell_tpu_torch.core._place import f64
from russell_tpu_torch.math.basic import gamma as _gamma

__all__ = ["ProbabilityDistribution", "DistributionFrechet",
           "DistributionGumbel", "DistributionLognormal",
           "DistributionNormal", "DistributionUniform"]

EULER = 0.5772156649015328606
FRECHET_MIN_DELTA_X = 1e-15
SQRT2 = math.sqrt(2.0)
# the least uniform draw of the Gumbel transform (jax.random.gumbel's
# minval): torch.rand may return 0, whose -log(-log(0)) is -inf
TINY = torch.finfo(torch.float64).tiny


class ProbabilityDistribution(ABC):
    """pdf/cdf/mean/variance/sample contract
    (probability_distribution.rs:4)."""

    @abstractmethod
    def pdf(self, x, device=None):
        ...

    @abstractmethod
    def cdf(self, x, device=None):
        ...

    @abstractmethod
    def mean(self) -> float:
        ...

    @abstractmethod
    def variance(self) -> float:
        ...

    @abstractmethod
    def sample(self, generator: torch.Generator, shape=()):
        ...


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rand(generator, shape):
    """Uniform f64 draws on [0, 1) on the generator's device."""
    return torch.rand(_shape(shape), generator=generator,
                      device=generator.device, dtype=torch.float64)


def _randn(generator, shape):
    """Standard normal f64 draws on the generator's device."""
    return torch.randn(_shape(shape), generator=generator,
                       device=generator.device, dtype=torch.float64)


def _uniform(generator, shape, lo, hi):
    """Uniform on [lo, hi) as jax.random.uniform computes it."""
    return torch.clamp(_rand(generator, shape) * (hi - lo) + lo, min=lo)


class DistributionFrechet(ProbabilityDistribution):
    """Frechet (inverse Weibull) (distribution_frechet.rs:15)."""

    def __init__(self, location: float, scale: float, shape: float):
        if scale <= 0.0 or shape <= 0.0:
            raise ValueError("invalid parameters")
        self.location = location
        self.scale = scale
        self.shape = shape

    def pdf(self, x, device=None):
        x = f64(x, device)
        z = (x - self.location) / self.scale
        zs = torch.clamp(z, min=1e-300)
        val = (torch.exp(-zs ** -self.shape) * zs ** (-1.0 - self.shape)
               * self.shape / self.scale)
        return torch.where(x - self.location < FRECHET_MIN_DELTA_X, 0.0, val)

    def cdf(self, x, device=None):
        x = f64(x, device)
        z = torch.clamp((x - self.location) / self.scale, min=1e-300)
        val = torch.exp(-z ** -self.shape)
        return torch.where(x - self.location < FRECHET_MIN_DELTA_X, 0.0, val)

    def mean(self) -> float:
        if self.shape > 1.0:
            return self.location + self.scale * float(
                _gamma(1.0 - 1.0 / self.shape, device="cpu"))
        return math.inf

    def variance(self) -> float:
        if self.shape > 2.0:
            g1 = float(_gamma(1.0 - 1.0 / self.shape, device="cpu"))
            g2 = float(_gamma(1.0 - 2.0 / self.shape, device="cpu"))
            return self.scale ** 2 * (g2 - g1 * g1)
        return math.inf

    def sample(self, generator, shape=()):
        # inverse transform: x = loc + scale (-ln U)^(-1/shape)
        u = _uniform(generator, shape, 1e-12, 1.0)
        return self.location + self.scale * (-torch.log(u)) ** (
            -1.0 / self.shape)


class DistributionGumbel(ProbabilityDistribution):
    """Gumbel (type I extreme value) (distribution_gumbel.rs:13)."""

    def __init__(self, location: float, scale: float):
        if scale <= 0.0:
            raise ValueError("invalid parameters")
        self.location = location
        self.scale = scale

    @classmethod
    def new_from_mu_sig(cls, mu: float, sig: float) -> "DistributionGumbel":
        scale = sig * math.sqrt(6.0) / math.pi
        location = mu - EULER * scale
        return cls(location, scale)

    def pdf(self, x, device=None):
        mz = (self.location - f64(x, device)) / self.scale
        return torch.exp(mz) * torch.exp(-torch.exp(mz)) / self.scale

    def cdf(self, x, device=None):
        mz = (self.location - f64(x, device)) / self.scale
        return torch.exp(-torch.exp(mz))

    def mean(self) -> float:
        return self.location + EULER * self.scale

    def variance(self) -> float:
        return (math.pi * self.scale) ** 2 / 6.0

    def sample(self, generator, shape=()):
        u = _uniform(generator, shape, TINY, 1.0)
        return -torch.log(-torch.log(u)) * self.scale + self.location


class DistributionLognormal(ProbabilityDistribution):
    """Lognormal (distribution_lognormal.rs:13)."""

    def __init__(self, mu_logx: float, sig_logx: float):
        if sig_logx <= 0.0:
            raise ValueError("invalid parameters")
        self.mu = mu_logx
        self.sig = sig_logx

    @classmethod
    def new_from_mu_sig(cls, mu: float, sig: float) -> "DistributionLognormal":
        if mu <= 0.0:
            raise ValueError("mu must be positive")
        cv = sig / mu
        sig_logx = math.sqrt(math.log(1.0 + cv * cv))
        mu_logx = math.log(mu) - sig_logx ** 2 / 2.0
        return cls(mu_logx, sig_logx)

    def pdf(self, x, device=None):
        x0 = f64(x, device)
        x = torch.clamp(x0, min=1e-300)
        z = (torch.log(x) - self.mu) / self.sig
        val = torch.exp(-z * z / 2.0) / (x * self.sig
                                         * math.sqrt(2 * math.pi))
        return torch.where(x0 <= 0.0, 0.0, val)

    def cdf(self, x, device=None):
        x0 = f64(x, device)
        x = torch.clamp(x0, min=1e-300)
        z = (torch.log(x) - self.mu) / (self.sig * SQRT2)
        return torch.where(x0 <= 0.0, 0.0, 0.5 * (1.0 + torch.special.erf(z)))

    def mean(self) -> float:
        return math.exp(self.mu + self.sig ** 2 / 2.0)

    def variance(self) -> float:
        s2 = self.sig ** 2
        return (math.exp(s2) - 1.0) * math.exp(2.0 * self.mu + s2)

    def sample(self, generator, shape=()):
        return torch.exp(_randn(generator, shape) * self.sig + self.mu)


class DistributionNormal(ProbabilityDistribution):
    """Normal (distribution_normal.rs:11)."""

    def __init__(self, mu: float, sig: float):
        if sig <= 0.0:
            raise ValueError("invalid parameters")
        self.mu = mu
        self.sig = sig

    def pdf(self, x, device=None):
        z = (f64(x, device) - self.mu) / self.sig
        return torch.exp(-z * z / 2.0) / (self.sig * math.sqrt(2 * math.pi))

    def cdf(self, x, device=None):
        z = (f64(x, device) - self.mu) / (self.sig * SQRT2)
        return 0.5 * (1.0 + torch.special.erf(z))

    def mean(self) -> float:
        return self.mu

    def variance(self) -> float:
        return self.sig ** 2

    def sample(self, generator, shape=()):
        return _randn(generator, shape) * self.sig + self.mu


class DistributionUniform(ProbabilityDistribution):
    """Uniform on [xmin, xmax] (distribution_uniform.rs:10)."""

    def __init__(self, xmin: float, xmax: float):
        if xmax <= xmin:
            raise ValueError("invalid parameters")
        self.xmin = xmin
        self.xmax = xmax

    def pdf(self, x, device=None):
        x = f64(x, device)
        inside = (x >= self.xmin) & (x <= self.xmax)
        return torch.where(inside, 1.0 / (self.xmax - self.xmin),
                           torch.zeros_like(x))

    def cdf(self, x, device=None):
        x = f64(x, device)
        return torch.clamp((x - self.xmin) / (self.xmax - self.xmin), 0.0,
                           1.0)

    def mean(self) -> float:
        return (self.xmin + self.xmax) / 2.0

    def variance(self) -> float:
        return (self.xmax - self.xmin) ** 2 / 12.0

    def sample(self, generator, shape=()):
        return _uniform(generator, shape, self.xmin, self.xmax)
