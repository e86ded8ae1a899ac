"""Where the port's entry points run."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the CUDA device; there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
