"""Diagonal Gaussian value type (mirrors ``dmme_tpu/equations/gaussian.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
