"""DiT, the Diffusion Transformer denoiser with adaLN-Zero conditioning
(mirrors ``dmme_tpu/models/dit.py``; Peebles & Xie 2023).

Same contract as the UNets: ``forward(x, t, *, y=None, train=False,
generator=None)`` over NHWC images with integer or float timesteps, so a
DiT drops into every harness and every sampler but the feature-caching
ones (which need the UNet's feature capture). ``out_channels = 2 ·
in_channels`` gives the IDDPM learned-variance head; ``in_channels = 2 ·
C`` the upsampler's x_t ‖ cond input.

Module names follow the flax tree (``patch_embed``, ``time_embed``,
``class_embed``, ``block_{i}/{adaln_mod,qkv,proj,mlp_in,mlp_out,moe_mlp}``,
``final_mod``, ``final_proj``), so ``utils.convert.from_flax`` loads a JAX
parameter tree unchanged. ``adaln_mod``, ``final_mod`` and ``final_proj``
start at zero (:class:`~dmme_tpu_torch.models.blocks.ZeroDense`): a fresh
DiT outputs exactly 0.

The LayerNorms are flax's ``LayerNorm(use_scale=False, use_bias=False)``:
f32 statistics with E[x²] − E[x]² clamped at 0, epsilon 1e-6. Attention
goes through :func:`~dmme_tpu_torch.ops.attention.attention_heads` (K3 on a
CUDA tensor) on q, k and v as strided views of the (N, T, 3, H, D) qkv
projection. With ``num_experts`` every ``moe_stride``-th block from the
second takes a :class:`~dmme_tpu_torch.models.moe.MoEMlp`; a forward given
a ``moe_losses`` list appends each MoE block's router statistics to it, in
block order. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``); the block's dropout mask and router noise
are drawn once, before, and the recomputation replays them.

On a ``tensor`` mesh axis (``parallel/tensor.py``) the DiT runs on a tensor
group's column shards (:meth:`~dmme_tpu_torch.models.blocks.TensorParallel.
place_tensor`), as the UNet does: the token activations between layers are
the rank's contiguous 1/T of the hidden channels, the gated residual sums
run on the shard, and the shard is all-gathered before each layer that
reads every channel. A block gathers its input before each LayerNorm, so
the statistics are the whole row's, computed alike on every rank; adaLN's
packed (N, 6·hidden) modulation and qkv's (3, heads, hd) columns are not a
rank's channels, so both are gathered whole and sliced. The attention runs
whole on every rank (K3 at the same shapes as one process), and ``proj``
keeps the rank's columns of its output; the MLP's hidden layer runs on
``mlp_in``'s columns and is gathered before ``mlp_out``. A MoE block hands
its layer the whole normalized input (so every rank routes alike, bitwise)
and takes back the rank's channels; its router statistics, alike on every
rank, go through ``TensorGroup.to_partial`` as the output does. The final
layer's output is gathered whole before the unpatchify.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dmme_tpu_torch.models.blocks import (Conv, Dense, TensorParallel, TimeEmbedding, ZeroDense,
                                          shard_of_output, whole_output)
from dmme_tpu_torch.models.moe import MoEMlp
from dmme_tpu_torch.models.unet import check_param_dtype
from dmme_tpu_torch.ops.attention import attention_heads

#: flax's LayerNorm epsilon
LN_EPS = 1e-6


def posemb_sincos_2d(gh: int, gw: int, dim: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Fixed 2D sin-cos positional embedding, (gh·gw, dim): channels
    [sin x, cos x, sin y, cos y], ω_k = exp(−k·log(10000)/max(dim/4 − 1, 1))."""
    assert dim % 4 == 0, f"posemb dim {dim} must be divisible by 4"
    quarter = dim // 4
    omega = torch.exp(torch.arange(quarter, dtype=torch.float32, device=device)
                      * -(math.log(10000.0) / max(quarter - 1, 1)))
    yy, xx = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=device),
                            torch.arange(gw, dtype=torch.float32, device=device), indexing="ij")
    y = yy.reshape(-1)[:, None] * omega[None, :]
    x = xx.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)], dim=1).to(dtype)


def layer_norm(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(use_scale=False, use_bias=False)`` over the last axis:
    f32 mean and E[x²] − mean² (clamped at 0), epsilon 1e-6, out in ``dtype``."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(torch.square(xf), dim=-1, keepdim=True) - torch.square(mean),
                      min=0.0)
    return ((xf - mean) * torch.rsqrt(var + LN_EPS)).to(dtype)


def _modulate(h: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return h * (1.0 + scale) + shift


class PatchEmbed(Conv):
    """``nn.Conv(hidden, (p, p), strides=p, padding="VALID")`` on NHWC input:
    one (p·p·C) × hidden product a patch; OIHW weight."""

    def __init__(self, c_in: int, hidden: int, patch_size: int, dtype=torch.float32):
        super().__init__(c_in, hidden, patch_size, patch_size, dtype)
        self.padding = 0


class DiTBlock(nn.Module):
    """One transformer block with adaLN-Zero conditioning: a zero-initialised
    Dense on SiLU(c) gives shift/scale/gate for the attention and the MLP
    branch, so both residual branches start gated off. Given a tensor
    group's channel shard of ``x``, it returns its shard of the output."""

    #: the ``TensorGroup`` of a tensor-split model (:meth:`TensorParallel.place_tensor`)
    tensor_group = None

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, moe_router_noise: float = 1.0,
                 moe_sinkhorn_iters: int = 8, dtype=torch.float32, remat: bool = False):
        super().__init__()
        assert hidden % num_heads == 0, (hidden, num_heads)
        self.hidden, self.num_heads, self.dropout = hidden, num_heads, dropout
        self.dtype, self.remat = dtype, remat
        self.mlp_dim = mlp_dim = int(hidden * mlp_ratio)
        self.adaln_mod = ZeroDense(hidden, 6 * hidden, dtype)
        self.qkv = Dense(hidden, 3 * hidden, dtype)
        self.proj = Dense(hidden, hidden, dtype)
        self.moe_mlp = None
        if num_experts > 0:
            self.moe_mlp = MoEMlp(hidden, num_experts, mlp_dim, moe_top_k, moe_capacity_factor,
                                  moe_router_noise, moe_sinkhorn_iters, dtype)
        else:
            self.mlp_in = Dense(hidden, mlp_dim, dtype)
            self.mlp_out = Dense(mlp_dim, hidden, dtype)

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """The training draws of one call on ``x``: the MLP's dropout keep
        mask (dense blocks with dropout; whole, also where ``mlp_in`` is a
        column shard) and the router noise (MoE blocks, with a generator),
        None where not drawn."""
        mask = noise = None
        if self.moe_mlp is None and self.dropout > 0.0:
            mask = torch.rand((x.shape[0], x.shape[1], self.mlp_dim), generator=generator,
                              device=x.device) < 1.0 - self.dropout
        if self.moe_mlp is not None and self.moe_mlp.router_noise > 0 and generator is not None:
            noise = torch.randn((x.shape[0] * x.shape[1], self.moe_mlp.num_experts),
                                generator=generator, device=x.device)
        return mask, noise

    def forward(self, x: torch.Tensor, c: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                moe_losses: Optional[List[Dict[str, torch.Tensor]]] = None,
                draws=None, recompute: bool = False) -> torch.Tensor:
        """``draws`` and ``recompute`` are the remat recomputation's: it runs
        the block on the draws of the first call."""
        if train and draws is None:
            draws = self.draw(x, generator)
        if self.remat and train and torch.is_grad_enabled() and not recompute:
            # the weights in effect now go in as inputs and are bound again
            # for the recomputation, which runs after the outer binding ended
            params = dict(self.named_parameters())
            keys: List[str] = []

            def body(x, c, mask, noise, *weights):
                stats: list = []
                h = functional_call(self, dict(zip(params, weights)), (x, c),
                                    {"train": True, "draws": (mask, noise),
                                     "moe_losses": stats, "recompute": True})
                keys[:] = sorted(stats[0]) if stats else []
                return (h,) + tuple(stats[0][k] for k in keys)

            out = checkpoint(body, x, c, *draws, *params.values(), use_reentrant=False)
            if keys and moe_losses is not None:
                moe_losses.append(dict(zip(keys, out[1:])))
            return out[0]
        mask, noise = draws if train else (None, None)

        n, t, d = x.shape
        group = self.tensor_group
        split = d != self.hidden  # a tensor group's channel shard
        heads, head_dim = self.num_heads, self.hidden // self.num_heads
        # the packed modulation whole: a rank's columns of it are not its channels
        mod = whole_output(self.adaln_mod, F.silu(c))[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
        if split:
            g1, g2 = group.shard(g1), group.shard(g2)

        h = _modulate(layer_norm(group.gather(x) if split else x, self.dtype), sh1, sc1)
        qkv = whole_output(self.qkv, h).reshape(n, t, 3, heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (n, t, heads, hd) views
        attn = attention_heads(q, k, v, head_dim ** -0.5).reshape(n, t, self.hidden)
        x = x + g1 * (shard_of_output(self.proj, attn, group) if split else self.proj(attn))

        h = _modulate(layer_norm(group.gather(x) if split else x, self.dtype), sh2, sc2)
        if self.moe_mlp is not None:
            h, stats = self.moe_mlp(h, train=train, noise=noise)
            if split:
                h = h if h.shape[-1] == d else group.shard(h)
                stats = {k: group.to_partial(v) for k, v in stats.items()}
            if moe_losses is not None:
                moe_losses.append(stats)
        else:
            h = self.mlp_in(h)
            columns = split and self.mlp_in.sharded
            h = F.gelu(h, approximate="tanh")
            if mask is not None:
                h = torch.where(group.shard(mask) if columns else mask, h / (1.0 - self.dropout),
                                torch.zeros((), dtype=h.dtype, device=h.device))
            if columns:
                h = group.gather(h)
            h = shard_of_output(self.mlp_out, h, group) if split else self.mlp_out(h)
        return x + g2 * h


class DiT(TensorParallel):
    """Diffusion Transformer over NHWC images. Defaults: DiT-S-ish at patch
    4 (64 tokens on 32×32). ``num_classes`` adds a class table with a
    trailing null row, as the UNets', for classifier-free guidance.
    Parameters are float32; ``param_dtype`` takes no other value yet.

    Bound to a tensor group's shards of its split leaves (after
    :meth:`place_tensor`), a forward runs tensor-parallel and returns the
    whole output on every rank of the group; bound to whole weights, the
    same module runs as on one device and issues no collective."""

    def __init__(self, patch_size: int = 4, hidden: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, in_channels: int = 3,
                 out_channels: Optional[int] = None, num_classes: Optional[int] = None,
                 pos_dim: int = 256, dropout: float = 0.0, num_experts: int = 0,
                 moe_stride: int = 2, moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 moe_router_noise: float = 1.0, moe_sinkhorn_iters: int = 8,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        check_param_dtype(param_dtype)
        self.patch_size, self.hidden, self.depth = patch_size, hidden, depth
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.num_classes, self.dtype = num_classes, dtype
        self.patch_embed = PatchEmbed(in_channels, hidden, patch_size, dtype)
        self.time_embed = TimeEmbedding(pos_dim, hidden, dtype)
        if num_classes is not None:
            self.class_embed = nn.Embedding(num_classes + 1, hidden)  # last row: null token
        for i in range(depth):
            # MoE in every moe_stride-th block from the second: routing on
            # the raw patch embeddings of block 0 would be noise
            moe_here = num_experts > 0 and i % moe_stride == 1 % moe_stride
            self.add_module(f"block_{i}", DiTBlock(
                hidden, num_heads, mlp_ratio, dropout, num_experts if moe_here else 0,
                moe_top_k, moe_capacity_factor, moe_router_noise, moe_sinkhorn_iters, dtype,
                remat))
        self.final_mod = ZeroDense(hidden, 2 * hidden, dtype)
        self.final_proj = ZeroDense(hidden, patch_size * patch_size * self.out_channels, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, y: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                moe_losses: Optional[List[Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
        """Predict from NHWC ``x`` at timesteps ``t`` (N,) (integers or
        floats); ``y``: the labels of a class-conditional model. ``train``
        enables dropout and the routers' noise and balancing, drawn from
        ``generator``. ``moe_losses``: a list that receives each MoE block's
        router statistics."""
        n, ih, iw, ic = x.shape
        p = self.patch_size
        assert ih % p == 0 and iw % p == 0, f"image {ih}x{iw} not divisible by patch {p}"
        assert ic == self.in_channels, (ic, self.in_channels)
        gh, gw = ih // p, iw // p
        group = self._tensor_split()

        pos = posemb_sincos_2d(gh, gw, self.hidden, self.dtype, x.device)[None]
        if group is None:
            h = self.patch_embed(x)
        else:  # the rank's channels of the tokens
            h = shard_of_output(self.patch_embed, x, group)
            pos = group.shard(pos)
        h = h.reshape(n, gh * gw, -1) + pos
        c = self.time_embed(t)  # whole: adaLN reads every channel of it
        if self.num_classes is not None:
            assert y is not None, "class-conditional DiT needs labels y"
            label = self.class_embed(y.to(device=c.device, dtype=torch.int64))
            if label.shape[-1] != c.shape[-1]:  # a column shard of the table
                label = group.gather(label)
            c = c + label.to(self.dtype)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, c, train=train, generator=generator,
                                            moe_losses=moe_losses)

        mod = whole_output(self.final_mod, F.silu(c))[:, None, :]
        shift, scale = torch.chunk(mod, 2, dim=-1)
        if group is not None:
            h = group.gather(h)
        h = whole_output(self.final_proj, _modulate(layer_norm(h, self.dtype), shift, scale))
        h = h.reshape(n, gh, gw, p, p, self.out_channels)
        out = h.permute(0, 1, 3, 2, 4, 5).reshape(n, ih, iw, self.out_channels).to(torch.float32)
        return out if group is None else group.to_partial(out)


def DiT_S(patch_size: int = 4, **kwargs) -> DiT:
    """DiT-S: hidden 384, depth 12, 6 heads (32,499,120 parameters at patch 4)."""
    return DiT(patch_size=patch_size, hidden=384, depth=12, num_heads=6, **kwargs)


def DiT_B(patch_size: int = 4, **kwargs) -> DiT:
    """DiT-B: hidden 768, depth 12, 12 heads."""
    return DiT(patch_size=patch_size, hidden=768, depth=12, num_heads=12, **kwargs)


def DiT_L(patch_size: int = 4, **kwargs) -> DiT:
    """DiT-L: hidden 1024, depth 24, 16 heads."""
    return DiT(patch_size=patch_size, hidden=1024, depth=24, num_heads=16, **kwargs)
