"""Noise draws and schedule padding (mirrors ``dmme_tpu/utils/noise.py``).

The draws are functions of an explicit ``torch.Generator``, as the JAX
package's are of a key, and land on the generator's device.
"""

from __future__ import annotations

import torch


def gaussian(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard normal sample of ``shape``."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


def gaussian_like(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Standard normal sample shaped and typed like ``x``."""
    return gaussian(generator, x.shape, x.dtype)


def uniform_int(generator: torch.Generator, minval: int, maxval: int,
                count: int = 1) -> torch.Tensor:
    """``count`` uniform integers in ``[minval, maxval)`` (int64, the port's
    index type). The upper bound is exclusive, as ``torch.randint``'s: DDPM
    training draws t ∈ [1, T) and never t = T."""
    return torch.randint(minval, maxval, (count,), generator=generator, device=generator.device)


def pad(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Prepend one row equal to ``value`` along dim 0.

    Schedules are stored with length ``T+1`` and a sentinel at index 0, so the
    index equals the paper's 1-based timestep ``t``.
    """
    lead = torch.full_like(x[0:1], value)
    return torch.cat([lead, x], dim=0)
