"""ε-prediction UNet with the DDPM defaults (mirrors ``dmme_tpu/models/ddpm.py``):
channels (128, 256, 256, 256), 2 blocks per depth, single-head attention at
depth 2, GroupNorm(32), dropout 0.1 — 32,416,643 parameters for RGB."""

from __future__ import annotations

import torch

from dmme_tpu_torch.models.unet import UNet as _UNet


def UNet(
    in_channels: int = 3,
    pos_dim: int = 128,
    emb_dim: int = 512,
    num_groups: int = 32,
    dropout: float = 0.1,
    channels_per_depth=(128, 256, 256, 256),
    num_blocks: int = 2,
    attention_depths=(2,),
    dtype=torch.float32,
    param_dtype=torch.float32,
    remat: bool = False,
    fused_norm: bool = False,
    fused_block: bool = False,
    num_classes=None,
    out_channels=None,
) -> _UNet:
    return _UNet(
        in_channels=in_channels,
        out_channels=out_channels or in_channels,
        pos_dim=pos_dim,
        emb_dim=emb_dim,
        num_groups=num_groups,
        dropout=dropout,
        channels_per_depth=tuple(channels_per_depth),
        num_blocks=num_blocks,
        attention_depths=tuple(attention_depths),
        film=False,
        num_heads=1,
        dtype=dtype,
        fused_norm=fused_norm,
        fused_block=fused_block,
        remat=remat,
        param_dtype=param_dtype,
        num_classes=num_classes,
    )
