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


def check_param_dtype(param_dtype) -> None:
    """The port keeps every parameter in float32; other parameter dtypes are
    ROADMAP A.13."""
    if param_dtype not in (torch.float32, "float32", "f32", "fp32"):
        raise NotImplementedError(f"param_dtype={param_dtype}: parameters other than float32 "
                                  "are not ported to dmme_tpu_torch yet (ROADMAP A.13: small "
                                  "leftovers)")


class UNet(nn.Module):
    """Timestep-conditioned UNet denoiser on NHWC tensors.

    ``film=False, num_heads=1`` is the DDPM UNet; ``film=True`` with several
    heads the IDDPM one. ``fused_norm`` and ``fused_block`` select the fused
    GroupNorm+SiLU and fused ResBlock kernels; ``remat`` recomputes each
    ResBlock's activations in the backward of a training forward. None of
    the three changes a parameter.

    With ``num_classes`` the model is class-conditional: a label embedding,
    ``class_embed`` of ``num_classes + 1`` rows (the last is the null token of
    classifier-free guidance), is added to the time embedding, so the labels
    reach every ResBlock through its per-sample condition. Parameters are
    float32; ``param_dtype`` takes no other value yet.
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
        remat: bool = False,
        param_dtype: torch.dtype = torch.float32,
        num_classes: Optional[int] = None,
    ):
        super().__init__()
        check_param_dtype(param_dtype)
        self.dtype = dtype
        self.remat = remat
        self.channels_per_depth = tuple(channels_per_depth)
        self.num_blocks = num_blocks
        self.attention_depths = tuple(attention_depths)
        self.dropout = dropout
        self.fused_norm = fused_norm
        self.down_specs, self.middle_specs, self.up_specs = build_topology(
            channels_per_depth, num_blocks, attention_depths
        )

        def res(c_in, spec):
            return ResBlock(c_in, spec.c_out, emb_dim, spec.attention, num_heads, film,
                            num_groups, dropout, dtype, fused_norm, fused_block, remat)

        self.time_embed = TimeEmbedding(pos_dim, emb_dim, dtype)
        self.num_classes = num_classes
        if num_classes is not None:
            self.class_embed = nn.Embedding(num_classes + 1, emb_dim)
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

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, y: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None, return_features: bool = False,
                cached=None, cache_depth: Optional[int] = None,
                deep_cache: Optional[torch.Tensor] = None, return_deep: bool = False):
        """Predict noise from NHWC ``x`` in [-1, 1] at timesteps ``t`` of shape
        (N,): integers, or floats for the continuous-time algorithms (EDM's
        c_noise, flow's t·1000). ``y``: the (N,) integer labels of a
        class-conditional model (``num_classes`` is the null token), required
        there. ``train`` enables dropout, drawn from ``generator``.

        The feature-capture arguments serve the caching samplers
        (``diffusion/fast.py``, ``diffusion/deep_cache.py``):

        * ``return_features`` also returns the encoder state ``(h_bottom,
          skips)``; ``cached=<that state>`` skips the whole down path and
          decodes with the current timestep embedding.
        * with ``cache_depth``, resolution depths > ``cache_depth`` form the
          deep core: ``return_deep`` also returns the core's output, and
          ``deep_cache=<that tensor>`` skips the core (down suffix, middle,
          up prefix) and runs only the shallow layers, with fresh skips.
        """
        n_shallow_down = n_deep_up = None
        if deep_cache is not None and cache_depth is None:
            raise ValueError("deep_cache requires cache_depth")
        if cache_depth is not None:
            if cached is not None:
                raise ValueError("the deep cache and the encoder cache are exclusive")
            if not 1 <= cache_depth < len(self.channels_per_depth):
                raise ValueError(f"cache_depth must be in [1, {len(self.channels_per_depth)}), "
                                 f"got {cache_depth}")
            n_shallow_down = sum(1 for s in self.down_specs if s.depth <= cache_depth)
            assert all(s.depth <= cache_depth for s in self.down_specs[:n_shallow_down])
            assert all(s.depth > cache_depth for s in self.down_specs[n_shallow_down:])
            # the deep core ends with the Upsample back to cache_depth's resolution
            n_deep_up = next(i for i, s in enumerate(self.up_specs)
                             if s.kind == "up" and s.depth == cache_depth) + 1

        emb = self.time_embed(t)
        if self.num_classes is not None:
            if y is None:
                raise ValueError("a class-conditional UNet needs labels y")
            # flax's nn.Embed(dtype=...) casts the table to the compute dtype
            emb = emb + self.class_embed(y.to(device=emb.device, dtype=torch.int64)).to(self.dtype)
        reuse_deep = deep_cache is not None
        if cached is None:
            h = self.input_conv(x.to(self.dtype))
            skips = [h]
            n_down = n_shallow_down if reuse_deep else len(self.down_specs)
            for i, spec in enumerate(self.down_specs[:n_down]):
                layer = getattr(self, f"down_{i}")
                h = layer(h, emb, train, generator) if spec.kind == "res" else layer(h)
                skips.append(h)
        else:
            h, skips = cached
            skips = list(skips)
        features = (h, tuple(skips))

        deep = None
        if reuse_deep:
            h = deep_cache.to(self.dtype)
            up_start = n_deep_up
        else:
            for i in range(len(self.middle_specs)):
                h = getattr(self, f"middle_{i}")(h, emb, train, generator)
            up_start = 0
        for i, spec in enumerate(self.up_specs):
            if i < up_start:
                continue
            layer = getattr(self, f"up_{i}")
            if spec.kind == "res":
                h = layer(torch.cat([h, skips.pop()], dim=-1), emb, train, generator)
            else:
                h = layer(h)
            if return_deep and n_deep_up is not None and i == n_deep_up - 1:
                deep = h
        assert not skips, "unconsumed skip connections — topology mismatch"

        if self.fused_norm:
            h = self.out_norm(h)
        else:
            h = torch.nn.functional.silu(self.out_norm(h).to(self.dtype))
        h = self.output_conv(h)
        if return_deep:
            if deep is None:
                raise ValueError("return_deep requires cache_depth")
            return h, deep
        if return_features:
            return h, features
        return h
