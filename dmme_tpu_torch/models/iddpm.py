"""Variance-learning UNet with the IDDPM defaults (mirrors ``dmme_tpu/models/iddpm.py``):
FiLM timestep conditioning, 4-head attention at depths (2, 3), dropout 0.3,
and 2·C output channels (ε ‖ v) — 36,168,070 parameters for RGB."""

from __future__ import annotations

import torch

from dmme_tpu_torch.models.unet import UNet as _UNet


def UNet(
    in_channels: int = 3,
    pos_dim: int = 128,
    emb_dim: int = 512,
    num_groups: int = 32,
    dropout: float = 0.3,
    channels_per_depth=(128, 256, 256, 256),
    num_blocks: int = 2,
    attention_depths=(2, 3),
    num_heads: int = 4,
    dtype=torch.float32,
    param_dtype=torch.float32,
    remat: bool = False,
    fused_norm: bool = False,
    fused_block: bool = False,
    num_classes=None,
) -> _UNet:
    return _UNet(
        in_channels=in_channels,
        out_channels=2 * in_channels,
        pos_dim=pos_dim,
        emb_dim=emb_dim,
        num_groups=num_groups,
        dropout=dropout,
        channels_per_depth=tuple(channels_per_depth),
        num_blocks=num_blocks,
        attention_depths=tuple(attention_depths),
        film=True,
        num_heads=num_heads,
        dtype=dtype,
        fused_norm=fused_norm,
        fused_block=fused_block,
        remat=remat,
        param_dtype=param_dtype,
        num_classes=num_classes,
    )
