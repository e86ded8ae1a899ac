"""The ``spatial`` mesh axis: H-split activations and their collectives.

JAX gets spatial parallelism from one batch spec (the H axis of an image
leaf split over ``spatial``, :func:`~dmme_tpu_torch.parallel.mesh.
batch_sharding`) and its SPMD partitioner, which inserts halo exchanges
for the convs and cross-device reductions for the GroupNorm statistics;
the port writes them out. The S ranks of a spatial group share one batch
slice and its draws, as a tensor group does: each takes the same whole
images, draws t, ε and dropout as one batch rank and computes the loss
whole. The UNet takes the rank's H/S rows at its entry (:meth:`SpatialGroup.
window`: the rows and one halo row each side, straight from the whole
input) and gathers its output whole along H at its exit. In between,
every activation is the rank's contiguous rows:

* SiLU, dropout (the whole (N, 1, 1, C) mask, alike on every rank), the
  residual sums, the 1×1 convs and the Upsample's nearest ×2 run locally;
* each 3×3 conv first takes one halo row from each neighbour
  (:meth:`SpatialGroup.halo`; zero rows at the image's edges) and then
  runs with no H padding: H/S rows out at stride 1, H/(2S) at stride 2,
  where only the upper halo is read;
* each GroupNorm sums x and x² per (sample, channel) over its rows, adds
  the group's sums (:meth:`SpatialGroup.all_reduce_sum`) and normalizes
  its rows with the whole sample's statistics (``ops/group_norm.py``:
  :func:`~dmme_tpu_torch.ops.group_norm.group_norm_silu_rows` on the fused
  path);
* attention gathers its input whole along H, runs whole on every rank and
  keeps the rank's rows; the time and class embeddings run whole.

Gradients follow the ``tensor`` axis's convention (``parallel/tensor.py``):
a row shard's gradient on its rank is the whole gradient of those rows,
and a whole tensor's gradient on each rank of the group is a partial sum
whose sum over the group is its gradient. So a gather's backward sums the
partials and keeps the rank's rows (a reduce-scatter); taking rows of a
whole tensor is a slice, whose backward pads with zeros; a halo's backward
sends each halo row's gradient back to its owner, which adds it; the
all-reduce of the statistics has an all-reduce as its backward. The
output, gathered whole and alike on every rank, passes through
:meth:`SpatialGroup.to_partial` (the identity, whose backward divides by
S). Parameters are never split on the axis: every leaf is whole, and its
gradient on a rank is a partial sum over the group, which the train step's
all-reduce of whole leaves over the world completes (``batch_ranks``
counts data × fsdp × expert only; the loss, alike on the S ranks, is
divided by S first).

:class:`SpatialGroup` is what ``parallel.shard_state`` hands the UNet
(``UNet.place_spatial``). Its collectives take the tensors as they are,
CUDA ones included, over gloo or NCCL; the halo is an all-gather of each
rank's two edge rows (gloo on CUDA tensors has no point-to-point).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dmme_tpu_torch.parallel.tensor import ToPartial


def _all_gather_rows(x: torch.Tensor, where: "SpatialGroup") -> torch.Tensor:
    """The group's row shards of ``x`` concatenated along H (axis 1), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(where.size)]
    dist.all_gather(parts, x, group=where.group)
    return torch.cat(parts, dim=1)


def _reduce_scatter_rows(g: torch.Tensor, where: "SpatialGroup") -> torch.Tensor:
    """This rank's rows (axis 1) of ``g`` summed over the group."""
    chunks = [c.contiguous() for c in g.chunk(where.size, dim=1)]
    out = torch.empty_like(chunks[where.index])
    dist.reduce_scatter(out, chunks, group=where.group)
    return out


def _edges(a: torch.Tensor, b: torch.Tensor, where: "SpatialGroup"):
    """Every rank's pair of rows (a, b), each (N, 1, W, C), by one all-gather:
    a list of (N, 2, W, C) tensors in rank order."""
    pair = torch.cat([a, b], dim=1).contiguous()
    parts = [torch.empty_like(pair) for _ in range(where.size)]
    dist.all_gather(parts, pair, group=where.group)
    return parts


class GatherRows(torch.autograd.Function):
    """A row shard → the whole tensor on every rank of the group; the
    backward sums the ranks' partial gradients and keeps this rank's rows
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, where: "SpatialGroup") -> torch.Tensor:
        ctx.where = where
        return _all_gather_rows(x, where)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _reduce_scatter_rows(grad, ctx.where), None


class Halo(torch.autograd.Function):
    """(N, h, W, C) rows → (N, h + 2, W, C) (``lower=False``: h + 1): the
    upper neighbour's last row above, the lower neighbour's first row
    below, zero rows at the image's edges. The backward adds each halo
    row's gradient into the neighbour row it came from."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, where: "SpatialGroup", lower: bool) -> torch.Tensor:
        ctx.where, ctx.lower = where, lower
        parts = _edges(x[:, :1], x[:, -1:], where)
        zero = torch.zeros_like(x[:, :1])
        i = where.index
        rows = [parts[i - 1][:, 1:] if i > 0 else zero, x]
        if lower:
            rows.append(parts[i + 1][:, :1] if i + 1 < where.size else zero)
        return torch.cat(rows, dim=1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        where, i = ctx.where, ctx.where.index
        up = grad[:, :1]
        down = grad[:, -1:] if ctx.lower else torch.zeros_like(up)
        parts = _edges(up, down, where)
        dx = grad[:, 1:grad.shape[1] - 1 if ctx.lower else None].clone()
        if i > 0:  # the upper neighbour's lower halo was this rank's first row
            dx[:, :1] += parts[i - 1][:, 1:]
        if i + 1 < where.size:  # the lower neighbour's upper halo was this rank's last row
            dx[:, -1:] += parts[i + 1][:, :1]
        return dx, None, None


class AllReduceSum(torch.autograd.Function):
    """The sum over the group on every rank; the backward sums the ranks'
    partial gradients likewise."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, where: "SpatialGroup") -> torch.Tensor:
        ctx.where = where
        return where.reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.where.reduce_(grad.clone()), None


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialGroup:
    """Where an image's rows live on a ``spatial`` mesh axis: the process
    group of the ``size`` ranks that share a batch slice (None: the world)
    and this rank's place ``index`` in it (it holds rows [index·H/size,
    (index+1)·H/size) of every activation)."""

    group: Any
    size: int
    index: int

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, …) → this rank's (N, H/S, …); the backward pads with zeros."""
        return x.chunk(self.size, dim=1)[self.index]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H/S, …) → (N, H, …) on every rank (:class:`GatherRows`)."""
        return GatherRows.apply(x, self)

    def halo(self, x: torch.Tensor, lower: bool = True) -> torch.Tensor:
        """:class:`Halo`: the rows with a neighbour's row on each side."""
        return Halo.apply(x, self, lower)

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (N, H, W, C) ``x`` with one row each
        side, zero beyond the image: what :meth:`halo` gives on the rows,
        sliced from the whole tensor with no collective."""
        h = x.shape[1] // self.size
        return F.pad(x, (0, 0, 0, 0, 1, 1))[:, self.index * h:(self.index + 1) * h + 2]

    def reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place (no autograd); returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """:class:`AllReduceSum`."""
        return AllReduceSum.apply(t, self)

    def to_partial(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor axis's ``ToPartial``: the identity, whose backward divides by S."""
        return ToPartial.apply(x, self.size)
