"""Schedule padding (mirrors ``dmme_tpu/utils/noise.py``)."""

from __future__ import annotations

import torch


def pad(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Prepend one row equal to ``value`` along dim 0.

    Schedules are stored with length ``T+1`` and a sentinel at index 0, so the
    index equals the paper's 1-based timestep ``t``.
    """
    lead = torch.full_like(x[0:1], value)
    return torch.cat([lead, x], dim=0)
