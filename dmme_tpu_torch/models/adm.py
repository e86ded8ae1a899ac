"""ADM, the guided-diffusion UNet family (mirrors ``dmme_tpu/models/adm.py``).

Against the DDPM/IDDPM UNet (:mod:`dmme_tpu_torch.models.unet`): BigGAN
ResBlocks that resample inside the block, a second conv, attention
projection and output conv that start at zero (:class:`~dmme_tpu_torch.
models.blocks.ZeroConv`: a fresh network outputs exactly 0), attention with
``num_head_channels`` a head scaled by ``head_dim**-0.5`` at several
resolutions, a label embedding, and a per-level ``channel_mult``.

* :func:`ADM`  — the generator preset (128 px, class-conditional by default).
* :func:`ADMG` — the class-conditional generator of classifier guidance;
  pair it with :func:`classifier` (:class:`EncoderUNet`, the noisy
  classifier) and ``dmme_tpu_torch.diffusion.ClassifierGuidedDDPM``/``DDIM``.
* :func:`ADMU` — the upsampler (low-resolution image concatenated on
  channels: 6 input channels).

GroupNorm and SiLU are library ops here, as in JAX (which never calls its
fused GroupNorm or ResBlock kernels on ADM); the attention goes through
:func:`~dmme_tpu_torch.ops.attention.attention_heads`, so K3 on the card.
Module names follow the flax tree (``down_{l}_{i}``, ``down_attn_{l}_{i}``,
``downsample_{l}``, ``middle_{0,1}``, ``middle_attn``, ``up_{l}_{i}``,
``up_attn_{l}_{i}``, ``upsample_{l}``), so ``utils.convert.from_flax`` loads
a JAX tree unchanged. Parameters are float32; ``dtype`` is the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmme_tpu_torch.models.blocks import (Dense, GroupNorm, ZeroConv, conv1x1, conv3x3,
                                          sinusoidal_position_embedding)
from dmme_tpu_torch.models.unet import check_param_dtype
from dmme_tpu_torch.ops.attention import attention_heads

#: groups of every ADM GroupNorm
GROUPS = 32


def _nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avgpool2x(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ADMResBlock(nn.Module):
    """Scale-shift-norm ResBlock: GN→SiLU, resample (h and the skip x), conv,
    GN·(1 + scale) + shift with (shift, scale) = Dense(SiLU(emb)), SiLU,
    dropout, zero-initialised conv, + skip (1×1 where the width changes).
    Dropout is elementwise, drawn from ``generator``."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int, dropout: float = 0.0,
                 up: bool = False, down: bool = False, dtype=torch.float32):
        super().__init__()
        self.c_out, self.dropout, self.up, self.down, self.dtype = c_out, dropout, up, down, dtype
        self.norm1 = GroupNorm(GROUPS, c_in)
        self.conv1 = conv3x3(c_in, c_out, 1, dtype)
        self.emb_proj = Dense(emb_dim, 2 * c_out, dtype)
        self.norm2 = GroupNorm(GROUPS, c_out)
        self.conv2 = ZeroConv(c_out, c_out, 3, 1, dtype)
        self.skip = conv1x1(c_in, c_out, dtype) if c_in != c_out else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.silu(self.norm1(x).to(self.dtype))
        if self.up:
            h, x = _nearest2x(h), _nearest2x(x)
        elif self.down:
            h, x = _avgpool2x(h), _avgpool2x(x)
        h = self.conv1(h)
        shift, scale = torch.chunk(self.emb_proj(F.silu(emb))[:, None, None, :], 2, dim=-1)
        h = F.silu(self.norm2(h).to(self.dtype) * (1.0 + scale) + shift)
        if train and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
        h = self.conv2(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class ADMAttention(nn.Module):
    """Residual multi-head attention, ``max(C // num_head_channels, 1)``
    heads scaled by ``head_dim**-0.5``, the projection zero-initialised."""

    def __init__(self, channels: int, num_head_channels: int = 64, dtype=torch.float32):
        super().__init__()
        self.heads = max(channels // num_head_channels, 1)
        self.dtype = dtype
        self.GroupNorm_0 = GroupNorm(GROUPS, channels)
        self.qkv = conv1x1(channels, 3 * channels, dtype)
        self.proj = ZeroConv(channels, channels, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        hd = c // self.heads
        # NHWC storage for the projection, so q, k and v are views with unit
        # stride along the head dim that K3 reads in place (blocks.SelfAttention2d)
        hx = self.GroupNorm_0(x).to(self.dtype, memory_format=torch.contiguous_format)
        qkv = self.qkv(hx).reshape(n, h * w, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = attention_heads(q, k, v, hd ** -0.5).reshape(n, h, w, c)
        return x + self.proj(out)


class _Trunk(nn.Module):
    """The time embedding (sinusoidal → Dense → SiLU → Dense, no SiLU after
    the second), the input conv, the down path and the middle, shared by
    :class:`UNetModel` and :class:`EncoderUNet`."""

    def _build_trunk(self, in_channels, model_channels, num_res_blocks, attention_resolutions,
                     channel_mult, num_head_channels, dropout, image_size, dtype,
                     resample_dropout: bool):
        ch = model_channels
        emb_dim = 4 * ch
        self.model_channels, self.dtype = ch, dtype
        self.channel_mult, self.num_res_blocks = tuple(channel_mult), num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.Dense_0 = Dense(ch, emb_dim, dtype)
        self.Dense_1 = Dense(emb_dim, emb_dim, dtype)
        self.input_conv = conv3x3(in_channels, ch, 1, dtype)
        # the down path as groups of block names in call order, a skip
        # recorded after each group; the channels of every skip
        self.down_path, skips = [], [ch]
        c, res_size = ch, image_size
        d_res = dropout if resample_dropout else 0.0
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                group = [self._add(f"down_{level}_{i}",
                                   ADMResBlock(c, ch * mult, emb_dim, dropout, dtype=dtype))]
                c = ch * mult
                if res_size in self.attention_resolutions:
                    group.append(self._add(f"down_attn_{level}_{i}",
                                           ADMAttention(c, num_head_channels, dtype)))
                self.down_path.append(group)
                skips.append(c)
            if level != len(self.channel_mult) - 1:
                self.down_path.append([self._add(f"downsample_{level}", ADMResBlock(
                    c, c, emb_dim, d_res, down=True, dtype=dtype))])
                skips.append(c)
                res_size //= 2
        self.middle_0 = ADMResBlock(c, c, emb_dim, d_res, dtype=dtype)
        self.middle_attn = ADMAttention(c, num_head_channels, dtype)
        self.middle_1 = ADMResBlock(c, c, emb_dim, d_res, dtype=dtype)
        return c, skips, emb_dim, res_size

    def _add(self, name: str, block: nn.Module) -> str:
        """Register ``block`` as ``name``; returns the name."""
        self.add_module(name, block)
        return name

    def _embed(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_position_embedding(t, self.model_channels, self.dtype)
        return self.Dense_1(F.silu(self.Dense_0(emb)))

    def _group(self, names, h, emb, train, generator):
        for name in names:
            block = getattr(self, name)
            h = block(h, emb, train, generator) if isinstance(block, ADMResBlock) else block(h)
        return h

    def _down(self, h, emb, train, generator, skips=None):
        for names in self.down_path:
            h = self._group(names, h, emb, train, generator)
            if skips is not None:
                skips.append(h)
        return h

    def _middle(self, h, emb, train, generator):
        h = self.middle_0(h, emb, train, generator)
        h = self.middle_attn(h)
        return self.middle_1(h, emb, train, generator)


class UNetModel(_Trunk):
    """The ADM generator UNet on NHWC tensors.

    ``attention_resolutions`` are feature-map sizes (e.g. (32, 16, 8) at
    128 px); ``num_classes`` adds a label embedding (``label_emb``, one row
    a class) to the time embedding. ``out_channels`` defaults to 2·C with
    ``learn_sigma`` (ε ‖ v) and to C without. ``middle_attn`` runs whatever
    ``attention_resolutions`` says."""

    def __init__(
        self,
        image_size: int = 128,
        in_channels: int = 3,
        model_channels: int = 256,
        out_channels: Optional[int] = None,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (32, 16, 8),
        channel_mult: Sequence[int] = (1, 1, 2, 3, 4),
        num_head_channels: int = 64,
        dropout: float = 0.0,
        num_classes: Optional[int] = None,
        learn_sigma: bool = True,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        check_param_dtype(param_dtype)
        self.image_size, self.num_classes = image_size, num_classes
        c, skips, emb_dim, res_size = self._build_trunk(
            in_channels, model_channels, num_res_blocks, attention_resolutions, channel_mult,
            num_head_channels, dropout, image_size, dtype, resample_dropout=True)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_dim)
        ch = model_channels
        # groups as the down path's; each up_{l}_{i} group concatenates a skip first
        self.up_path = []
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                group = [self._add(f"up_{level}_{i}", ADMResBlock(
                    c + skips.pop(), ch * mult, emb_dim, dropout, dtype=dtype))]
                c = ch * mult
                if res_size in self.attention_resolutions:
                    group.append(self._add(f"up_attn_{level}_{i}",
                                           ADMAttention(c, num_head_channels, dtype)))
                self.up_path.append(group)
            if level != 0:
                self.up_path.append([self._add(f"upsample_{level}", ADMResBlock(
                    c, c, emb_dim, dropout, up=True, dtype=dtype))])
                res_size *= 2
        assert not skips, "unconsumed skip connections — topology mismatch"
        out_ch = out_channels or (2 * in_channels if learn_sigma else in_channels)
        self.out_norm = GroupNorm(GROUPS, c)
        self.out_conv = ZeroConv(c, out_ch, 3, 1, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None,
                return_features: bool = False, cached=None):
        """ε (‖ v) for NHWC ``x`` at timesteps ``t`` ((N,)); ``y``: the labels
        of a class-conditional model. ``return_features`` also returns the
        encoder state ``(h_bottom, skips)``; ``cached=<that state>`` skips the
        input conv and the down path (``diffusion.fast.CachedDDIM``'s API)."""
        emb = self._embed(t)
        if self.num_classes is not None:
            if y is None:
                raise ValueError("a class-conditional ADM needs labels y")
            # flax's nn.Embed(dtype=...) casts the table to the compute dtype
            emb = emb + self.label_emb(y.to(device=emb.device, dtype=torch.int64)).to(self.dtype)
        if cached is None:
            h = self.input_conv(x.to(self.dtype))
            skips = [h]
            h = self._down(h, emb, train, generator, skips)
        else:
            h, skips = cached
            skips = list(skips)
        features = (h, tuple(skips))
        h = self._middle(h, emb, train, generator)
        for names in self.up_path:
            if names[0].startswith("up_"):
                h = torch.cat([h, skips.pop()], dim=-1)
            h = self._group(names, h, emb, train, generator)
        assert not skips, "unconsumed skip connections — topology mismatch"
        out = self.out_conv(F.silu(self.out_norm(h).to(self.dtype)))
        if return_features:
            return out, features
        return out


class EncoderUNet(_Trunk):
    """The ADM noisy classifier: the generator's down trunk and middle, then
    attention pooling (a softmax over positions of ``pool_w``'s logits, in
    f32) into ``num_classes`` logits. Dropout reaches the down blocks only."""

    def __init__(
        self,
        image_size: int = 128,
        in_channels: int = 3,
        model_channels: int = 128,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (32, 16, 8),
        channel_mult: Sequence[int] = (1, 1, 2, 3, 4),
        num_head_channels: int = 64,
        num_classes: int = 1000,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        check_param_dtype(param_dtype)
        self.image_size, self.num_classes = image_size, num_classes
        c, _, _, _ = self._build_trunk(
            in_channels, model_channels, num_res_blocks, attention_resolutions, channel_mult,
            num_head_channels, dropout, image_size, dtype, resample_dropout=False)
        self.pool_norm = GroupNorm(GROUPS, c)
        self.pool_w = Dense(c, 1, dtype)
        self.logits = Dense(c, num_classes, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, num_classes) logits of NHWC ``x`` at timesteps ``t``."""
        emb = self._embed(t)
        h = self._down(self.input_conv(x.to(self.dtype)), emb, train, generator)
        h = self._middle(h, emb, train, generator)
        h = F.silu(self.pool_norm(h).to(self.dtype))
        n, hh, ww, c = h.shape
        flat = h.reshape(n, hh * ww, c)
        weights = torch.softmax(self.pool_w(flat).to(torch.float32), dim=1).to(self.dtype)
        return self.logits(torch.sum(flat * weights, dim=1))


# ---------------------------------------------------------------- presets

_ADM_PRESETS = {
    32: dict(model_channels=128, channel_mult=(1, 2, 2, 2), num_res_blocks=3,
             attention_resolutions=(16, 8)),
    64: dict(model_channels=192, channel_mult=(1, 2, 3, 4), num_res_blocks=3,
             attention_resolutions=(32, 16, 8)),
    128: dict(model_channels=256, channel_mult=(1, 1, 2, 3, 4), num_res_blocks=2,
              attention_resolutions=(32, 16, 8)),
    256: dict(model_channels=256, channel_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
              attention_resolutions=(32, 16, 8)),
}
_CLASSIFIER_PRESETS = {
    32: dict(model_channels=64, channel_mult=(1, 2, 2, 2), num_res_blocks=2,
             attention_resolutions=(16, 8)),
    64: dict(model_channels=128, channel_mult=(1, 2, 3, 4), num_res_blocks=2,
             attention_resolutions=(32, 16, 8)),
    128: dict(model_channels=128, channel_mult=(1, 1, 2, 3, 4), num_res_blocks=2,
              attention_resolutions=(32, 16, 8)),
}


def ADM(image_size: int = 128, class_conditional: bool = True, num_classes: int = 1000,
        dtype=torch.float32, **overrides) -> UNetModel:
    """The generator preset for ``image_size`` (guided-diffusion's
    hyperparameters; ``overrides`` replace them). ADM(32,
    class_conditional=False) has 57,094,662 parameters."""
    cfg = (_ADM_PRESETS.get(image_size) or {}) | overrides
    return UNetModel(image_size=image_size,
                     num_classes=num_classes if class_conditional else None, dtype=dtype,
                     **cfg)


def ADMG(image_size: int = 128, num_classes: int = 1000, dtype=torch.float32,
         **overrides) -> UNetModel:
    """The classifier-guided generator: the class-conditional ADM."""
    return ADM(image_size, True, num_classes, dtype, **overrides)


def ADMU(image_size: int = 256, dtype=torch.float32, **overrides) -> UNetModel:
    """The upsampler: x_t ‖ the bilinear-upsampled low-resolution image on
    channels (6 input channels)."""
    cfg = dict(model_channels=192, channel_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
               attention_resolutions=(32, 16, 8), in_channels=6) | overrides
    return UNetModel(image_size=image_size, num_classes=None, dtype=dtype, **cfg)


def classifier(image_size: int = 128, num_classes: int = 1000, dtype=torch.float32,
               **overrides) -> EncoderUNet:
    """The noisy-classifier preset for ``image_size``. classifier(32,
    num_classes=10) has 4,287,627 parameters."""
    cfg = (_CLASSIFIER_PRESETS.get(image_size) or {}) | overrides
    return EncoderUNet(image_size=image_size, num_classes=num_classes, dtype=dtype, **cfg)


__all__ = ["ADMResBlock", "ADMAttention", "UNetModel", "EncoderUNet", "ADM", "ADMG", "ADMU",
           "classifier"]
