"""Where the port's entry points run, and in which f32 precision."""

from __future__ import annotations

import contextlib
import os
from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the CUDA device: under a launcher (``LOCAL_RANK`` set)
    ``cuda:(LOCAL_RANK mod cards)``, the rank's card. There is no silent
    CPU fallback."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        if local is not None and torch.cuda.is_available():
            device = f"cuda:{int(local) % torch.cuda.device_count()}"
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for matmuls and cuDNN convolutions in this scope; the
    caller's flags come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
