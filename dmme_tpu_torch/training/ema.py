"""Exponential moving average of parameters (mirrors ``dmme_tpu/training/ema.py``)."""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema ← decay·ema + (1 − decay)·params, in place (JAX returns a new
    tree; updating in place keeps one copy of the EMA weights on the card)."""
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[k].to(e.dtype) for k, e in ema_params.items()],
                        alpha=1.0 - decay)
