"""UNet building blocks, NHWC (mirrors ``dmme_tpu/models/blocks.py``).

Parameters live in float32; each layer casts them and its input to the
compute ``dtype`` (bf16 on the serving path), as flax's ``dtype`` does.
GroupNorm statistics are taken in float32 with torch's eps = 1e-5. Conv
weights are OIHW and Dense weights (out, in), PyTorch's own layouts;
:func:`dmme_tpu_torch.utils.convert.from_flax` maps the JAX package's
parameters onto them. Module and parameter names follow the JAX tree, so a
``state_dict`` key reads ``down_1.norm2.weight`` where flax has
``down_1/norm2/scale``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dmme_tpu_torch.ops.attention import attention_heads
from dmme_tpu_torch.ops.group_norm import group_norm_silu
from dmme_tpu_torch.ops.resblock import resblock_forward

# torch nn.GroupNorm's epsilon (flax defaults to 1e-6)
GN_EPS = 1e-5


def sinusoidal_position_embedding(t: torch.Tensor, dim: int,
                                  dtype=torch.float32) -> torch.Tensor:
    """(N, dim) embedding: freqs_k = exp(−k·log(10000)/(dim/2 − 1)),
    output = [sin(t·f), cos(t·f)]."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * -(math.log(10000.0) / (half - 1))
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(dtype)


class Dense(nn.Module):
    """``flax.linen.Dense``: y = x·Wᵀ + b in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class ZeroDense(Dense):
    """A :class:`Dense` whose kernel starts at zero (flax's ``kernel_init=
    zeros``, DiT's adaLN-Zero layers): :func:`init_weights` leaves it at zero."""


class Conv(nn.Module):
    """NHWC convolution with symmetric padding, OIHW weight, compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = kernel_size // 2
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the NCHW view of an NHWC tensor is channels_last, which cuDNN keeps
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
                     self.bias.to(self.dtype), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ZeroConv(Conv):
    """A :class:`Conv` whose kernel starts at zero (flax's ``kernel_init=
    zeros``): :func:`init_weights` leaves it at zero."""


def conv3x3(c_in: int, c_out: int, stride: int = 1, dtype=torch.float32) -> Conv:
    return Conv(c_in, c_out, 3, stride, dtype)


def conv1x1(c_in: int, c_out: int, dtype=torch.float32) -> Conv:
    return Conv(c_in, c_out, 1, 1, dtype)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` with torch-parity eps, f32 in and out."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.to(torch.float32).permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, GN_EPS)
        return y.permute(0, 2, 3, 1)


class GNSiLU(GroupNorm):
    """GroupNorm(+pre-bias, +FiLM)+SiLU through the fused kernel
    (:mod:`dmme_tpu_torch.ops.group_norm`). Same parameters as
    :class:`GroupNorm`, so the switch leaves the ``state_dict`` unchanged."""

    def __init__(self, num_groups: int, channels: int, dtype=torch.float32):
        super().__init__(num_groups, channels)
        self.dtype = dtype

    def forward(self, x, pre_bias=None, film_scale=None, film_shift=None):
        if film_scale is not None:
            # GN(x)·(s+1)+shift with the GN affine folded in, per sample
            fs = film_scale.to(torch.float32) + 1.0
            gamma = self.weight[None, :] * fs
            beta = self.bias[None, :] * fs + film_shift.to(torch.float32)
        else:
            gamma, beta = self.weight, self.bias
        y = group_norm_silu(x, gamma, beta, self.num_groups, GN_EPS, pre_bias=pre_bias)
        return y.to(self.dtype)


class TimeEmbedding(nn.Module):
    """Sinusoidal embedding + 2-layer SiLU MLP (the UNet's condition head)."""

    def __init__(self, pos_dim: int = 128, emb_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.pos_dim = pos_dim
        self.dtype = dtype
        self.Dense_0 = Dense(pos_dim, emb_dim, dtype)
        self.Dense_1 = Dense(emb_dim, emb_dim, dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_position_embedding(t, self.pos_dim, self.dtype)
        return F.silu(self.Dense_1(F.silu(self.Dense_0(emb))))


class SelfAttention2d(nn.Module):
    """Pre-norm residual self-attention over the H·W token grid.

    The softmax scale is ``dim**-0.5`` over the full channel dim even with
    several heads, and the qkv projection packs channels as (3, heads, hd),
    as in the JAX package.
    """

    def __init__(self, dim: int, num_groups: int = 32, num_heads: int = 1,
                 dtype=torch.float32):
        super().__init__()
        assert dim % num_heads == 0
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.GroupNorm_0 = GroupNorm(num_groups, dim)
        self.qkv_proj = conv1x1(dim, 3 * dim, dtype)
        self.proj = conv1x1(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        heads = self.num_heads
        # F.group_norm returns channel-major storage on CUDA; casting to NHWC
        # in the same copy keeps the projection channels-last, so q, k and v
        # are views with unit stride along the head dim that K3 reads in place
        hx = self.GroupNorm_0(x).to(self.dtype, memory_format=torch.contiguous_format)
        qkv = self.qkv_proj(hx).reshape(n, h * w, 3, heads, c // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (n, hw, heads, hd) views
        out = attention_heads(q, k, v, self.dim ** -0.5).reshape(n, h, w, c)
        return x + self.proj(out)


class Downsample(nn.Module):
    """Stride-2 3×3 conv, padding 1."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels, 2, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv to ``c_out`` channels (default: ``channels``)."""

    def __init__(self, channels: int, dtype=torch.float32, c_out: Optional[int] = None):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels if c_out is None else c_out, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.Conv_0(x)


class ResBlock(nn.Module):
    """GN→SiLU→Conv ×2 residual block with timestep conditioning.

    * additive (DDPM): ``h = conv1(x); h += Dense(emb); h = conv2(h); h += skip(x)``
    * FiLM (IDDPM): ``h = gn(conv1(x))·(scale+1)+shift`` with
      (shift, scale) = Dense(2·c_out)(emb)

    In training, dropout drops whole feature maps (torch ``Dropout2d``)
    before the second conv; the mask is the block's only draw from the
    generator and is drawn first, so with ``remat`` the recomputation in the
    backward reuses it. ``remat`` recomputes the block's activations in the
    backward instead of keeping them (``torch.utils.checkpoint``, as
    ``nn.remat(ResBlock)`` in JAX). ``fused_norm`` routes each GN+SiLU
    through the fused GroupNorm kernel; ``fused_block`` runs the whole block,
    in eval, through the fused ResBlock kernel. Parameters are the same
    either way.
    """

    def __init__(self, c_in: int, c_out: int, emb_dim: int, with_attention: bool = False,
                 num_heads: int = 1, film: bool = False, num_groups: int = 32,
                 dropout: float = 0.1, dtype=torch.float32, fused_norm: bool = False,
                 fused_block: bool = False, remat: bool = False):
        super().__init__()
        self.c_out, self.film, self.num_groups = c_out, film, num_groups
        self.dropout, self.dtype = dropout, dtype
        self.fused_norm, self.fused_block, self.remat = fused_norm, fused_block, remat
        norm = (lambda c: GNSiLU(num_groups, c, dtype)) if fused_norm else (
            lambda c: GroupNorm(num_groups, c))
        self.norm1 = norm(c_in)
        self.conv1 = conv3x3(c_in, c_out, 1, dtype)
        self.condition = Dense(emb_dim, (2 if film else 1) * c_out, dtype)
        self.norm2 = norm(c_out)
        self.conv2 = conv3x3(c_out, c_out, 1, dtype)
        self.residual = conv1x1(c_in, c_out, dtype) if c_in != c_out else None
        self.attention = (SelfAttention2d(c_out, num_groups, num_heads, dtype)
                          if with_attention else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, recompute: bool = False) -> torch.Tensor:
        """``mask`` and ``recompute`` are the remat recomputation's: it runs
        the block on the dropout mask drawn the first time."""
        if self.fused_block and not train:
            h = self._fused_block(x, emb)
            return h if self.attention is None else self.attention(h)
        if train and self.dropout > 0.0 and not recompute:
            keep = 1.0 - self.dropout
            mask = torch.rand((x.shape[0], 1, 1, self.c_out), generator=generator,
                              device=x.device) < keep
        if self.remat and train and torch.is_grad_enabled() and not recompute:
            # the weights in effect now (those an outer functional_call bound)
            # go in as inputs and are bound again for the recomputation, which
            # runs in the backward, after the outer binding has ended
            params = dict(self.named_parameters())

            def body(x, emb, mask, *weights):
                return functional_call(self, dict(zip(params, weights)), (x, emb),
                                       {"train": True, "mask": mask, "recompute": True})

            return checkpoint(body, x, emb, mask, *params.values(), use_reentrant=False)
        h = self._standard(x, emb, mask)
        return h if self.attention is None else self.attention(h)

    def _standard(self, x, emb, mask):
        if self.fused_norm:
            h = self.norm1(x)
        else:
            h = F.silu(self.norm1(x).to(self.dtype))
        h = self.conv1(h)
        cond = self.condition(emb)
        if self.film:
            shift, scale = torch.chunk(cond, 2, dim=-1)  # (N, C) each
            if self.fused_norm:
                h = self.norm2(h, film_scale=scale, film_shift=shift)
            else:
                h = self.norm2(h).to(self.dtype)
                h = F.silu(h * (scale[:, None, None, :] + 1.0) + shift[:, None, None, :])
        elif self.fused_norm:
            # GN(h + cond) + SiLU in one kernel: the pre-bias folds into the statistics
            h = self.norm2(h, pre_bias=cond)
        else:
            h = F.silu(self.norm2(h + cond[:, None, None, :]).to(self.dtype))
        if mask is not None:
            h = torch.where(mask, h / (1.0 - self.dropout),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        h = self.conv2(h)
        skip = x if self.residual is None else self.residual(x)
        return h + skip

    def _fused_block(self, x, emb):
        """Inference path through the fused ResBlock kernel sequence."""
        n = x.shape[0]
        cond = self.condition(emb).to(torch.float32)
        g1, b1v = self.norm1.weight, self.norm1.bias
        if self.film:
            shift, scale = torch.chunk(cond, 2, dim=-1)
            fs = scale + 1.0
            g2 = self.norm2.weight[None] * fs
            b2v = self.norm2.bias[None] * fs + shift
            pre2 = torch.zeros_like(g2)
        else:
            pre2 = cond
            g2 = self.norm2.weight[None].expand(n, -1)
            b2v = self.norm2.bias[None].expand(n, -1)
        res = self.residual
        return resblock_forward(
            x.to(self.dtype),
            g1[None].expand(n, -1), b1v[None].expand(n, -1), pre2, g2, b2v,
            self.conv1.weight, self.conv1.bias, self.conv2.weight, self.conv2.bias,
            wr=None if res is None else res.weight,
            br=None if res is None else res.bias,
            num_groups=self.num_groups, eps=GN_EPS,
        )


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                   fan_in: Optional[int] = None) -> None:
    """flax's default kernel init: truncated normal on [−2σ, 2σ] with
    variance 1/fan_in, by the inverse CDF as ``jax.random.truncated_normal``.
    ``fan_in`` defaults to the elements of one output row (PyTorch's layouts)."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.special.erfinv(u)
    with torch.no_grad():
        w.copy_((z * std).to(w.dtype))


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax default init, drawn from ``generator``: lecun-normal kernels
    (zero for a :class:`ZeroConv` or :class:`ZeroDense`), zero biases,
    GroupNorm scale 1 and bias 0, and embedding tables normal with variance
    1/features (``nn.Embed``'s ``variance_scaling(1.0, "fan_in", "normal",
    out_axis=0)``). A module with an ``init_parameters(generator)`` method
    (the MoE layer's expert stacks) draws its own parameters."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_parameters"):
                m.init_parameters(generator)
            elif isinstance(m, (ZeroConv, ZeroDense)):
                m.weight.zero_()
                m.bias.zero_()
            elif isinstance(m, (Dense, Conv)):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = math.sqrt(1.0 / m.embedding_dim)
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module
