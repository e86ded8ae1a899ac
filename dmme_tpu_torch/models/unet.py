"""The UNet topology as a static layer plan plus one ``nn.Module``
(mirrors ``dmme_tpu/models/unet.py``).

Skip-connection discipline: the down path records the feature map after the
input conv and after every down layer, Downsamples included; every up-path
ResBlock pops one record and concatenates it along channels.

On a ``tensor`` mesh axis (``parallel/tensor.py``) the UNet runs on channel
shards (:meth:`UNet.place_tensor`): every activation between layers, the
skips included, is the rank's slice of its channels, and the up path's
concatenation is gathered whole and re-split, since a rank's slice of
``cat([h, skip])`` is not the concatenation of the two slices.

On a ``spatial`` mesh axis (``parallel/spatial.py``) a training forward
runs on H-shards (:meth:`UNet.place_spatial`): the input conv reads the
rank's rows of the whole input with a halo row each side, every
activation between layers, the skips included, is the rank's rows (the
concatenations are local), and the output is gathered whole.

On both axes a training forward runs on the rank's rows of its channel
shard of every activation: the input conv reads its rows' window of the
whole input and keeps its channel shard, the up path gathers each
concatenation's channels over the tensor group (rows stay local), and at
the exit the channels are gathered over the tensor group, the output conv
runs on the rows with their halo, and the rows are gathered over the
spatial group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence, Tuple

import torch
from torch import nn

from dmme_tpu_torch.models.blocks import (
    Downsample,
    GNSiLU,
    GroupNorm,
    ResBlock,
    SpatialParallel,
    TensorParallel,
    TimeEmbedding,
    Upsample,
    conv3x3,
    on_rows,
    whole_output,
)
from dmme_tpu_torch.parallel.tensor import ToPartial


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


class UNet(TensorParallel, SpatialParallel):
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

    Bound to a tensor group's shards of its split leaves (after
    :meth:`place_tensor`), a training forward runs tensor-parallel and
    returns the whole output on every rank of the group; bound to whole
    weights, the same module runs as on one device and issues no
    collective. After :meth:`place_spatial`, a training forward runs on the
    rank's rows of every activation and returns the whole output on every
    rank of the spatial group; any other forward runs on whole images.
    After both, a training forward runs on the rank's rows of its channel
    shards and returns the whole output on every rank of the two groups.
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

    def check_rows(self, height: int, size: int) -> None:
        """Raise unless every level's rows of a ``height``-row input split
        into whole shards over ``size`` spatial ranks, an even number a
        shard where a Downsample halves them: ``height`` divisible by
        ``size`` · 2^(depths − 1)."""
        levels = len(self.channels_per_depth)
        unit = size * 2 ** (levels - 1)
        if height % unit:
            raise ValueError(
                f"an H-split UNet of {levels} depths over {size} spatial ranks needs a height "
                f"divisible by {unit} (whole, even row shards at every level), got {height} "
                "(ROADMAP A.11)")

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

        Bound to tensor shards (:meth:`place_tensor`), every rank of the
        group returns the whole output, whose backward divides its gradient
        by the group's size (``TensorGroup.to_partial``); so does a
        training forward of a UNet placed on a spatial axis
        (:meth:`place_spatial`, ``SpatialGroup.to_partial``). Placed on
        both, a training forward returns the whole output on each of the
        T·S ranks that share its batch slice, and its backward divides by
        T·S once.
        """
        group = self._tensor_split()
        spatial = self._spatial_split(train)
        capture = (return_features or return_deep or cached is not None
                   or cache_depth is not None or deep_cache is not None)
        if group is not None and capture:
            raise ValueError("the feature-capture arguments sample on whole weights; a "
                             "tensor-split UNet samples after TrainState.whole()")
        if spatial is not None:
            if capture:
                raise ValueError("the feature-capture arguments sample on whole images; an "
                                 "H-split UNet runs on row shards in training only")
            self.check_rows(x.shape[1], spatial.size)
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
            label = self.class_embed(y.to(device=emb.device, dtype=torch.int64))
            if label.shape[-1] != emb.shape[-1]:  # a column shard of the table
                label = group.gather(label)
            emb = emb + label.to(self.dtype)
        reuse_deep = deep_cache is not None
        if cached is None:
            if spatial is not None:
                h = self.input_conv.valid_rows(spatial.window(x.to(self.dtype)))
            else:
                h = self.input_conv(x.to(self.dtype))
            if group is not None and not self.input_conv.sharded:
                h = group.shard(h)  # a kernel left whole: the rank's channels of it
            skips = [h]
            n_down = n_shallow_down if reuse_deep else len(self.down_specs)
            for i, spec in enumerate(self.down_specs[:n_down]):
                layer = getattr(self, f"down_{i}")
                h = (on_rows(layer, spatial, h, emb, train, generator) if spec.kind == "res"
                     else on_rows(layer, spatial, h))
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
                h = on_rows(getattr(self, f"middle_{i}"), spatial, h, emb, train, generator)
            up_start = 0
        for i, spec in enumerate(self.up_specs):
            if i < up_start:
                continue
            layer = getattr(self, f"up_{i}")
            if spec.kind == "res" and group is None:
                h = on_rows(layer, spatial, torch.cat([h, skips.pop()], dim=-1), emb, train,
                            generator)
            elif spec.kind == "res":
                # a rank's slice of the concatenation is not that of its parts
                whole = group.gather_cat(h, skips.pop())
                h = on_rows(layer, spatial, group.shard(whole), emb, train, generator,
                            whole=whole)
            else:
                h = on_rows(layer, spatial, h)
            if return_deep and n_deep_up is not None and i == n_deep_up - 1:
                deep = h
        assert not skips, "unconsumed skip connections — topology mismatch"

        if self.fused_norm:
            h = on_rows(self.out_norm, spatial, h)
        else:
            h = torch.nn.functional.silu(on_rows(self.out_norm, spatial, h).to(self.dtype))
        if group is not None or spatial is not None:
            if group is not None:
                h = group.gather(h)
            h = whole_output(self.output_conv, h, spatial)
            if spatial is not None:
                h = spatial.gather(h)
            # alike on the T·S ranks of the batch slice: divided once by T·S
            return ToPartial.apply(h, math.prod(g.size for g in (group, spatial) if g))
        h = self.output_conv(h)
        if return_deep:
            if deep is None:
                raise ValueError("return_deep requires cache_depth")
            return h, deep
        if return_features:
            return h, features
        return h
