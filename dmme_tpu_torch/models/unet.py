"""The UNet topology as a static layer plan plus one ``nn.Module``
(mirrors ``dmme_tpu/models/unet.py``).

Skip-connection discipline: the down path records the feature map after the
input conv and after every down layer, Downsamples included; every up-path
ResBlock pops one record and concatenates it along channels.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

import torch
from torch import nn

from dmme_tpu_torch.models.blocks import (
    Downsample,
    GNSiLU,
    GroupNorm,
    ResBlock,
    TimeEmbedding,
    Upsample,
    conv3x3,
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: Literal["res", "down", "up"]
    c_out: int
    attention: bool = False
    #: resolution depth of this layer's output (1 = input resolution)
    depth: int = 0


def build_topology(
    channels_per_depth: Sequence[int],
    num_blocks: int,
    attention_depths: Sequence[int],
) -> Tuple[Tuple[LayerSpec, ...], Tuple[LayerSpec, ...], Tuple[LayerSpec, ...]]:
    """(down, middle, up) layer plans: a channel ladder of
    ``1 + num_blocks·len(channels_per_depth)`` entries, a Downsample after
    each depth's blocks but the last, and an up path that walks the ladder
    backwards with an extra skip-consuming ResBlock + Upsample at each depth
    boundary, closing with one ResBlock at the input width."""
    cpd = tuple(channels_per_depth)
    attn = frozenset(attention_depths)
    ladder = [cpd[0]]
    for c in cpd:
        ladder.extend([c] * num_blocks)
    boundaries = {num_blocks * i for i in range(1, len(cpd))}

    down = []
    depth = 1
    for i in range(len(ladder) - 1):
        down.append(LayerSpec("res", ladder[i + 1], depth in attn, depth))
        if (i + 1) in boundaries:
            down.append(LayerSpec("down", ladder[i + 1], depth=depth + 1))
            depth += 1

    c_mid = ladder[-1]
    d_mid = len(cpd)
    middle = (
        LayerSpec("res", c_mid, True, d_mid),
        LayerSpec("res", c_mid, False, d_mid),
    )

    up = []
    rev = ladder[::-1]
    depth = len(cpd)
    for i in range(len(rev) - 1):
        c_out = rev[i + 1]
        with_attention = depth in attn
        layer_num = len(ladder) - 1 - i
        up.append(LayerSpec("res", c_out, with_attention, depth))
        if (layer_num - 1) in boundaries:
            up.append(LayerSpec("res", c_out, with_attention, depth))
            up.append(LayerSpec("up", c_out, depth=depth - 1))
            depth -= 1
    up.append(LayerSpec("res", ladder[0], 1 in attn, 1))

    return tuple(down), middle, tuple(up)


class UNet(nn.Module):
    """Timestep-conditioned UNet denoiser on NHWC tensors.

    ``film=False, num_heads=1`` is the DDPM UNet; ``film=True`` with several
    heads the IDDPM one. ``fused_norm`` and ``fused_block`` select the fused
    GroupNorm+SiLU and fused ResBlock kernels; they change no parameter.
    """

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: Optional[int] = None,
        pos_dim: int = 128,
        emb_dim: int = 512,
        num_groups: int = 32,
        dropout: float = 0.1,
        channels_per_depth: Tuple[int, ...] = (128, 256, 256, 256),
        num_blocks: int = 2,
        attention_depths: Tuple[int, ...] = (2,),
        film: bool = False,
        num_heads: int = 1,
        dtype: torch.dtype = torch.float32,
        fused_norm: bool = False,
        fused_block: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.fused_norm = fused_norm
        self.down_specs, self.middle_specs, self.up_specs = build_topology(
            channels_per_depth, num_blocks, attention_depths
        )

        def res(c_in, spec):
            return ResBlock(c_in, spec.c_out, emb_dim, spec.attention, num_heads, film,
                            num_groups, dropout, dtype, fused_norm, fused_block)

        self.time_embed = TimeEmbedding(pos_dim, emb_dim, dtype)
        c = channels_per_depth[0]
        self.input_conv = conv3x3(in_channels, c, 1, dtype)
        skips = [c]
        for i, spec in enumerate(self.down_specs):
            if spec.kind == "res":
                self.add_module(f"down_{i}", res(c, spec))
                c = spec.c_out
            else:
                self.add_module(f"down_{i}", Downsample(c, dtype))
            skips.append(c)
        for i, spec in enumerate(self.middle_specs):
            self.add_module(f"middle_{i}", res(c, spec))
            c = spec.c_out
        for i, spec in enumerate(self.up_specs):
            if spec.kind == "res":
                self.add_module(f"up_{i}", res(c + skips.pop(), spec))
                c = spec.c_out
            else:
                self.add_module(f"up_{i}", Upsample(c, dtype))
        assert not skips, "unconsumed skip connections — topology mismatch"
        self.out_norm = GNSiLU(num_groups, c, dtype) if fused_norm else GroupNorm(num_groups, c)
        self.output_conv = conv3x3(c, out_channels or in_channels, 1, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Predict noise from NHWC ``x`` in [-1, 1] at integer timesteps ``t``
        of shape (N,). ``train`` enables dropout, drawn from ``generator``."""
        emb = self.time_embed(t)
        h = self.input_conv(x.to(self.dtype))
        skips = [h]
        for i, spec in enumerate(self.down_specs):
            layer = getattr(self, f"down_{i}")
            h = layer(h, emb, train, generator) if spec.kind == "res" else layer(h)
            skips.append(h)
        for i in range(len(self.middle_specs)):
            h = getattr(self, f"middle_{i}")(h, emb, train, generator)
        for i, spec in enumerate(self.up_specs):
            layer = getattr(self, f"up_{i}")
            if spec.kind == "res":
                h = layer(torch.cat([h, skips.pop()], dim=-1), emb, train, generator)
            else:
                h = layer(h)
        if self.fused_norm:
            h = self.out_norm(h)
        else:
            h = torch.nn.functional.silu(self.out_norm(h).to(self.dtype))
        return self.output_conv(h)
