"""Diagonal Gaussian value type (mirrors ``dmme_tpu/equations/gaussian.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2 * pi)


class Gaussian(NamedTuple):
    """Diagonal Gaussian ``N(mean, std**2)``."""

    mean: torch.Tensor
    std: torch.Tensor

    @property
    def variance(self) -> torch.Tensor:
        return torch.square(self.std)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + std·ε`` with ε drawn from ``generator``, or the given
        ``noise`` (tests inject the reference's own draws)."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        return -0.5 * torch.square(z) - torch.log(self.std) - _HALF_LOG_2PI


def kl_divergence(q: Gaussian, p: Gaussian) -> torch.Tensor:
    """Elementwise ``KL(q || p)`` between diagonal Gaussians.

    The log of the variance ratio is taken from the two stds, not from their
    squared ratio: with the stds many decades apart (IDDPM's learned variance
    at t == 1) the ratio underflows to 0, and log(0) = -inf turns the
    backward of a where-masked branch into 0·inf = NaN."""
    var_ratio = torch.square(q.std / p.std)
    t1 = torch.square((q.mean - p.mean) / p.std)
    log_ratio = 2.0 * (torch.log(q.std) - torch.log(p.std))
    return 0.5 * (var_ratio + t1 - 1.0 - log_ratio)
