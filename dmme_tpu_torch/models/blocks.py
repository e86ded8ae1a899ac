"""UNet building blocks, NHWC (mirrors ``dmme_tpu/models/blocks.py``).

Parameters live in float32; each layer casts them and its input to the
compute ``dtype`` (bf16 on the serving path), as flax's ``dtype`` does.
GroupNorm statistics are taken in float32 with torch's eps = 1e-5. Conv
weights are OIHW and Dense weights (out, in), PyTorch's own layouts;
:func:`dmme_tpu_torch.utils.convert.from_flax` maps the JAX package's
parameters onto them. Module and parameter names follow the JAX tree, so a
``state_dict`` key reads ``down_1.norm2.weight`` where flax has
``down_1/norm2/scale``.

On a ``tensor`` mesh axis (``parallel/tensor.py``) the same modules run on
channel shards: a :class:`Conv` or :class:`Dense` bound to a column shard
of its kernel computes the rank's slice of the output channels with that
slice of its whole bias (:attr:`Conv.sharded`); a GroupNorm given a shard
of its channels normalizes the shard's G/T groups with its slice of the
affine; a block given a shard gathers it whole before each layer that
reads every channel (:func:`shard_of_output`, :func:`whole_output`). Each
module then holds the ``TensorGroup`` (:meth:`TensorParallel.place_tensor`);
with whole weights it is never read.

On a ``spatial`` mesh axis (``parallel/spatial.py``) the same modules run
on the rank's rows of each activation, given the ``SpatialGroup`` as
their ``spatial`` argument (None: whole images): a 3×3 :class:`Conv`
takes a halo row from each neighbour and pads W only, a 1×1 one runs on
the rows; :class:`GroupNorm` and :class:`GNSiLU` take their statistics
over the whole sample (the group's sums all-reduced);
:class:`SelfAttention2d` gathers its input whole and keeps its rows of
the output. The model holds the group (:meth:`SpatialParallel.place_spatial`).

The two compose: a rank of a mesh with both axes holds its rows of its
channel shard of each activation. The channel gathers before a layer
that reads every channel run over the tensor group (the ranks that hold
the same rows), then a 3×3 conv's halo rows, whole in C, over the
spatial group; the GroupNorm sums of the shard's G/T groups are
all-reduced over the spatial group (the ranks that hold the same
channels); the attention gathers the rows, then the channels.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dmme_tpu_torch.ops.attention import attention_heads
from dmme_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_rows
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


class TensorParallel(nn.Module):
    """A model that runs tensor-parallel where its weights are bound as a
    tensor group's shards (the UNet, the DiT): :meth:`place_tensor` hands
    every module the group, and :meth:`_tensor_split` tells a forward
    whether the weights bound now are shards (then it runs tensor-parallel
    and returns its whole output through ``TensorGroup.to_partial``) or
    whole (then it runs as on one device and issues no collective)."""

    #: (module, parameter, whole shape) of one tensor-split leaf: the
    #: forward runs tensor-parallel when that leaf is bound as a shard
    _tensor_probe = None

    def place_tensor(self, where, split: Mapping[str, int] = ()) -> None:
        """Hand every module the ``TensorGroup`` ``where`` (None: whole
        weights only). ``split``: the names of the leaves the tensor axis
        splits (``parallel.mesh.tensor_axes``), at least one. Raises where a
        GroupNorm's groups do not split whole over the group."""
        self._tensor_probe = None
        if where is not None:
            if not split:
                raise ValueError("the tensor axis splits no leaf of this model: a tensor mesh "
                                 "needs at least one split kernel (lower min_weight_size)")
            for m in self.modules():
                if isinstance(m, GroupNorm) and (m.num_groups % where.size
                                                 or m.weight.shape[0] % where.size):
                    raise ValueError(f"GroupNorm({m.num_groups} groups, {m.weight.shape[0]} "
                                     f"channels) cannot split whole over {where.size} tensor "
                                     "ranks")
            name = next(iter(split))
            module, _, leaf = name.rpartition(".")
            self._tensor_probe = (module, leaf, tuple(self.get_parameter(name).shape))
        for m in self.modules():
            m.tensor_group = where

    def _tensor_split(self):
        """The ``TensorGroup`` where the bound weights are its shards, else None."""
        probe = self._tensor_probe
        if probe is None:
            return None
        module, leaf, shape = probe
        bound = getattr(self.get_submodule(module), leaf)
        return self.tensor_group if tuple(bound.shape) != shape else None


def on_rows(layer: nn.Module, spatial, *args, **kwargs) -> torch.Tensor:
    """``layer(*args, **kwargs)``, given ``spatial=`` where the input is a
    spatial group's rows (with whole images, the one-device call as it is)."""
    return layer(*args, **kwargs) if spatial is None else layer(*args, spatial=spatial, **kwargs)


class SpatialParallel(nn.Module):
    """A model that runs on H-shards in training where a ``spatial`` mesh
    axis placed it (the UNet): :meth:`place_spatial` hands it the
    ``SpatialGroup``, and :meth:`_spatial_split` tells a forward whether to
    run on the rank's rows (a training forward of a placed model; it then
    returns its whole output through ``SpatialGroup.to_partial``) or on
    whole images, as on one device with no collective (every other
    forward: a spatial mesh samples, validates and tests on whole images)."""

    #: the ``SpatialGroup`` of a spatial mesh (:meth:`place_spatial`), or None
    spatial_group = None

    def place_spatial(self, where) -> None:
        """Hand the model the ``SpatialGroup`` ``where`` (None: whole images only)."""
        self.spatial_group = where

    def _spatial_split(self, train: bool):
        """The ``SpatialGroup`` where this forward runs on H-shards, else None."""
        return self.spatial_group if train else None


class _Columns(nn.Module):
    """A layer whose kernel may be bound as a column shard: the rank's
    1/T of its output rows (the ``tensor`` axis) beside the whole bias."""

    #: the ``TensorGroup`` of a tensor-split model (:meth:`TensorParallel.place_tensor`)
    tensor_group = None

    @property
    def sharded(self) -> bool:
        """Whether the bound kernel is a column shard."""
        return self.weight.shape[0] != self.bias.shape[0]

    def _bias(self) -> torch.Tensor:
        """The bias of the bound kernel's rows: the rank's slice where it is a shard."""
        return self.tensor_group.shard(self.bias) if self.sharded else self.bias


def whole_output(layer: "_Columns", x: torch.Tensor, spatial=None) -> torch.Tensor:
    """``layer`` on its whole input ``x``, its output whole: gathered over
    the tensor group where the bound kernel is a column shard. ``spatial``:
    the ``SpatialGroup`` whose rows ``x`` is (a :class:`Conv`'s halo)."""
    y = on_rows(layer, spatial, x)
    return layer.tensor_group.gather(y) if layer.sharded else y


def shard_of_output(layer: "_Columns", x: torch.Tensor, group, spatial=None) -> torch.Tensor:
    """This rank's channel shard of ``layer`` on its whole input ``x``: what
    a column shard of the kernel computes, or the rank's slice of the
    output of a kernel left whole (run alike on every rank). ``spatial``:
    the ``SpatialGroup`` whose rows ``x`` is (a :class:`Conv`'s halo)."""
    y = on_rows(layer, spatial, x)
    return y if layer.sharded else group.shard(y)


class Dense(_Columns):
    """``flax.linen.Dense``: y = x·Wᵀ + b in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self._bias().to(self.dtype))


class ZeroDense(Dense):
    """A :class:`Dense` whose kernel starts at zero (flax's ``kernel_init=
    zeros``, DiT's adaLN-Zero layers): :func:`init_weights` leaves it at zero."""


class Conv(_Columns):
    """NHWC convolution with symmetric padding, OIHW weight, compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = kernel_size // 2
        self.dtype = dtype

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        """``spatial``: the ``SpatialGroup`` whose rows ``x`` is (None: whole
        images); a 3×3 conv then takes a halo row from each neighbour (at
        stride 2 the upper one only) and pads W alone."""
        if spatial is None or self.padding == 0:
            return self._conv(x, self.padding)
        return self.valid_rows(spatial.halo(x, lower=self.stride == 1))

    def valid_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on rows that already carry their halo: no H padding."""
        return self._conv(x, (0, self.padding))

    def _conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        # the NCHW view of an NHWC tensor is channels_last, which cuDNN keeps
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
                     self._bias().to(self.dtype), self.stride, padding)
        return y.permute(0, 2, 3, 1)


class ZeroConv(Conv):
    """A :class:`Conv` whose kernel starts at zero (flax's ``kernel_init=
    zeros``): :func:`init_weights` leaves it at zero."""


def conv3x3(c_in: int, c_out: int, stride: int = 1, dtype=torch.float32) -> Conv:
    return Conv(c_in, c_out, 3, stride, dtype)


def conv1x1(c_in: int, c_out: int, dtype=torch.float32) -> Conv:
    return Conv(c_in, c_out, 1, 1, dtype)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` with torch-parity eps, f32 in and out. Given
    a tensor group's channel shard, it normalizes the shard's G/T groups."""

    #: the ``TensorGroup`` of a tensor-split model (:meth:`TensorParallel.place_tensor`)
    tensor_group = None

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def affine(self, channels: int):
        """(scale, shift, groups) for an input of ``channels`` channels: the
        whole ones, or the rank's slice and G/T groups of a channel shard.
        Raises where the shard is not a whole number of groups."""
        c = self.weight.shape[0]
        if channels == c:
            return self.weight, self.bias, self.num_groups
        group = self.tensor_group
        size = 0 if group is None else group.size
        if channels * size != c or self.num_groups % size:
            raise ValueError(f"GroupNorm({self.num_groups} groups, {c} channels) given {channels} "
                             f"channels: a tensor group of {size} ranks must split its groups "
                             f"whole (groups and channels divisible by {size})")
        return group.shard(self.weight), group.shard(self.bias), self.num_groups // size

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        """``spatial``: the ``SpatialGroup`` whose rows ``x`` is (None: whole
        images); the statistics are then the whole sample's,
        E[x²] − E[x]² from the group's all-reduced f32 sums."""
        weight, bias, groups = self.affine(x.shape[-1])
        if spatial is not None:
            return self._rows(x, weight, bias, groups, spatial)
        y = F.group_norm(x.to(torch.float32).permute(0, 3, 1, 2), groups, weight, bias, GN_EPS)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def _rows(x, weight, bias, groups, spatial):
        n, h, w, c = x.shape
        xf = x.to(torch.float32)
        sums = spatial.all_reduce_sum(torch.stack([xf.sum(dim=(1, 2)),
                                                   torch.square(xf).sum(dim=(1, 2))]))
        count = h * spatial.size * w * (c // groups)
        mean, sq = (sums.reshape(2, n, groups, c // groups).sum(-1) / count).unbind(0)
        inv = torch.rsqrt(sq - torch.square(mean) + GN_EPS)
        xg = xf.reshape(n, h, w, groups, c // groups)
        y = (xg - mean[:, None, None, :, None]) * inv[:, None, None, :, None]
        return y.reshape(n, h, w, c) * weight + bias


class GNSiLU(GroupNorm):
    """GroupNorm(+pre-bias, +FiLM)+SiLU through the fused kernel
    (:mod:`dmme_tpu_torch.ops.group_norm`). Same parameters as
    :class:`GroupNorm`, so the switch leaves the ``state_dict`` unchanged."""

    def __init__(self, num_groups: int, channels: int, dtype=torch.float32):
        super().__init__(num_groups, channels)
        self.dtype = dtype

    def forward(self, x, pre_bias=None, film_scale=None, film_shift=None, spatial=None):
        """``spatial``: the ``SpatialGroup`` whose rows ``x`` is (None:
        whole images), through the split entries (``group_norm_silu_rows``)."""
        weight, bias, groups = self.affine(x.shape[-1])
        if film_scale is not None:
            # GN(x)·(s+1)+shift with the GN affine folded in, per sample
            fs = film_scale.to(torch.float32) + 1.0
            gamma = weight[None, :] * fs
            beta = bias[None, :] * fs + film_shift.to(torch.float32)
        else:
            gamma, beta = weight, bias
        if spatial is not None:
            y = group_norm_silu_rows(x, gamma, beta, groups, GN_EPS, pre_bias, where=spatial)
        else:
            y = group_norm_silu(x, gamma, beta, groups, GN_EPS, pre_bias=pre_bias)
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
        return F.silu(whole_output(self.Dense_1, F.silu(whole_output(self.Dense_0, emb))))


class SelfAttention2d(nn.Module):
    """Pre-norm residual self-attention over the H·W token grid.

    The softmax scale is ``dim**-0.5`` over the full channel dim even with
    several heads, and the qkv projection packs channels as (3, heads, hd),
    as in the JAX package. Given a tensor group's channel shard, the block
    gathers the normalized input, gathers the projection's column shards
    (a rank's rows of the packed (3, heads, hd) layout are not its heads),
    runs the attention whole on every rank and keeps its shard of ``proj``.
    Given a spatial group's rows (``spatial``), it gathers them whole along
    H, runs the norm, the projection and the attention whole on every rank
    and keeps its rows of the output (``proj`` runs on those rows). Given
    both (a rank's rows of its channel shard), it gathers the rows along H
    over the spatial group, normalizes the shard's G/T groups on whole H
    (no statistics all-reduce), gathers the channels over the tensor
    group, runs the attention whole and keeps its rows of its shard of
    ``proj``.
    """

    def __init__(self, dim: int, num_groups: int = 32, num_heads: int = 1,
                 dtype=torch.float32):
        super().__init__()
        assert dim % num_heads == 0
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.GroupNorm_0 = GroupNorm(num_groups, dim)
        self.qkv_proj = conv1x1(dim, 3 * dim, dtype)
        self.proj = conv1x1(dim, dim, dtype)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        rows = x
        if spatial is not None:
            x = spatial.gather(x)
        n, h, w, c = x.shape
        heads, dim = self.num_heads, self.dim
        # F.group_norm returns channel-major storage on CUDA; casting to NHWC
        # in the same copy keeps the projection channels-last, so q, k and v
        # are views with unit stride along the head dim that K3 reads in place
        hx = self.GroupNorm_0(x).to(self.dtype, memory_format=torch.contiguous_format)
        split = c != dim  # a tensor group's channel shard
        if split:
            hx = self.tensor_group.gather(hx)
        qkv = whole_output(self.qkv_proj, hx).reshape(n, h * w, 3, heads, dim // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (n, hw, heads, hd) views
        out = attention_heads(q, k, v, dim ** -0.5).reshape(n, h, w, dim)
        if spatial is not None:
            x, out = rows, spatial.rows(out)
        if split:
            return x + shard_of_output(self.proj, out, self.tensor_group)
        return x + self.proj(out)


class Downsample(nn.Module):
    """Stride-2 3×3 conv, padding 1 (a channel shard in, a shard out)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels, 2, dtype)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        if x.shape[-1] != self.Conv_0.weight.shape[1]:  # a tensor group's channel shard
            group = self.Conv_0.tensor_group
            return shard_of_output(self.Conv_0, group.gather(x), group, spatial)
        return on_rows(self.Conv_0, spatial, x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv to ``c_out`` channels (default:
    ``channels``); a channel shard is gathered before the ×2."""

    def __init__(self, channels: int, dtype=torch.float32, c_out: Optional[int] = None):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels if c_out is None else c_out, 1, dtype)

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        group = self.Conv_0.tensor_group
        split = x.shape[-1] != self.Conv_0.weight.shape[1]  # a tensor group's channel shard
        if split:
            x = group.gather(x)
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        if split:
            return shard_of_output(self.Conv_0, x, group, spatial)
        return on_rows(self.Conv_0, spatial, x)


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

    Given a tensor group's channel shard of ``x`` (``whole``: the whole
    ``x``, where the caller has it), the block returns its shard of the
    output: both norms, the dropout (its slice of the whole mask) and the
    sum run on the shard, each conv reads the gathered activation, the
    condition is the rank's slice of the whole (N, c_out) or, under FiLM,
    the rank's slice of each half of the gathered (N, 2·c_out) (a rank's
    rows of the packed [shift | scale] are not its channels).

    Given a spatial group's rows of ``x`` (``spatial``), every layer runs on
    the rows (:class:`Conv`, :class:`GroupNorm`, :class:`GNSiLU` and the
    attention take ``spatial``); the dropout mask is the whole one.

    Given both (a ``tensor`` axis composed with ``spatial``: ``x`` is the
    rank's rows of its channel shard), the norms, the dropout and the sum
    run on it; each conv gathers the rows' channels over the tensor group
    and then, whole in C, takes its halo rows over the spatial group (the
    gather first: at T = 2 the same bytes as a halo of the C/T edge rows
    before a gather of h + 2 rows, and the conv's own H-split path
    unchanged); the 1×1 ``residual`` and the condition take no halo.
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
                mask: Optional[torch.Tensor] = None, recompute: bool = False,
                whole: Optional[torch.Tensor] = None, spatial=None) -> torch.Tensor:
        """``mask`` and ``recompute`` are the remat recomputation's: it runs
        the block on the dropout mask drawn the first time (and the same
        halos and all-reduces, in the same order on every rank)."""
        split = x.shape[-1] != self.norm1.weight.shape[0]  # a tensor group's channel shard
        if self.fused_block and not train and not split and spatial is None:
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

            def body(x, emb, mask, whole, *weights):
                return functional_call(self, dict(zip(params, weights)), (x, emb),
                                       {"train": True, "mask": mask, "recompute": True,
                                        "whole": whole, "spatial": spatial})

            return checkpoint(body, x, emb, mask, whole, *params.values(), use_reentrant=False)
        h = self._standard(x, emb, mask, whole, spatial)
        return h if self.attention is None else on_rows(self.attention, spatial, h)

    def _standard(self, x, emb, mask, whole=None, spatial=None):
        group = self.conv1.tensor_group
        split = x.shape[-1] != self.norm1.weight.shape[0]
        if self.fused_norm:
            h = on_rows(self.norm1, spatial, x)
        else:
            h = F.silu(on_rows(self.norm1, spatial, x).to(self.dtype))
        if split:
            h = shard_of_output(self.conv1, group.gather(h), group, spatial)
        else:
            h = on_rows(self.conv1, spatial, h)
        if self.film:
            shift, scale = torch.chunk(whole_output(self.condition, emb), 2, dim=-1)  # (N, C) each
            if split:
                shift, scale = group.shard(shift), group.shard(scale)
            if self.fused_norm:
                h = on_rows(self.norm2, spatial, h, film_scale=scale, film_shift=shift)
            else:
                h = on_rows(self.norm2, spatial, h).to(self.dtype)
                h = F.silu(h * (scale[:, None, None, :] + 1.0) + shift[:, None, None, :])
        else:
            cond = shard_of_output(self.condition, emb, group) if split else self.condition(emb)
            if self.fused_norm:
                # GN(h + cond) + SiLU in one kernel: the pre-bias folds into the statistics
                h = on_rows(self.norm2, spatial, h, pre_bias=cond)
            else:
                h = F.silu(on_rows(self.norm2, spatial, h + cond[:, None, None, :]).to(self.dtype))
        if mask is not None:
            h = torch.where(group.shard(mask) if split else mask, h / (1.0 - self.dropout),
                            torch.zeros((), dtype=h.dtype, device=h.device))
        if split:
            h = shard_of_output(self.conv2, group.gather(h), group, spatial)
            if self.residual is not None:
                whole = group.gather(x) if whole is None else whole
                return h + shard_of_output(self.residual, whole, group)
            return h + x
        h = on_rows(self.conv2, spatial, h)
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
    # in place, in one f64 buffer: the same operations in the same order as
    # sqrt(2)·erfinv(u·(hi − lo) + lo)·std, without a temporary a step
    z = torch.rand(w.shape, generator=generator, dtype=torch.float64).mul_(hi - lo).add_(lo)
    torch.special.erfinv(z, out=z).mul_(math.sqrt(2.0)).mul_(std)
    with torch.no_grad():
        w.copy_(z)


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
