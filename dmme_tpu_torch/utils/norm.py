"""Image range normalisation (mirrors ``dmme_tpu/utils/norm.py``)."""

import torch


def norm(x: torch.Tensor) -> torch.Tensor:
    """Linearly map ``[0, 1]`` to ``[-1, 1]``."""
    return (x - 0.5) * 2.0


def denorm(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`norm`, clipped back to ``[0, 1]``."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
