"""The ``tensor`` mesh axis: channel-split activations and their collectives.

JAX gets tensor parallelism from one spec rule (each kernel's output axis
split, :func:`~dmme_tpu_torch.parallel.mesh.fsdp_param_spec`) and its SPMD
partitioner; the port writes the scheme out (Megatron's column split). The
T ranks of a tensor group share one batch slice. A rank holds the column
shard of each split kernel: a layer given its whole input computes the
rank's 1/T of the output channels, plus that slice of its whole bias. An
activation flows between layers as the rank's contiguous 1/T of its
channels (GroupNorm, SiLU, dropout and the residual sums run on the shard)
and is all-gathered along channels before a layer that reads every
channel. A layer whose kernel JAX's rule leaves whole (small, or an output
width the axis does not divide) runs whole on every rank, redundantly, and
the rank keeps its slice of the output. No split weight is ever gathered
for the forward.

Gradients follow one convention, which makes every backward collective a
reduce-scatter: a channel shard's gradient on its rank is the whole
gradient of that shard, and a whole activation's gradient on each rank of
the group is a partial sum whose sum over the group is its gradient. A
gather's backward therefore sums the partials and keeps the rank's slice
(:class:`Gather`: a reduce-scatter). Taking a shard of a whole tensor is a
slice, whose backward puts the shard's gradient in place among zeros, a
partial sum, with no collective. A layer run whole on every rank turns
partial output gradients into partial input and weight gradients. The
network's output is gathered whole and passed through :func:`to_partial`
(the identity, whose backward divides by T), so the loss each rank
computes on it seeds the convention. Hence:

* a split kernel's gradient is the whole gradient of the rank's shard, and
  is summed over its replicas only (the other batch ranks);
* a whole leaf's gradient (a bias or GroupNorm affine used a slice a rank,
  a small kernel run whole) is a partial sum over the tensor group, so the
  all-reduce of whole leaves over the world, divided by the batch ranks,
  is right as it stands.

:class:`TensorGroup` is what ``parallel.shard_state`` hands the model
(``TensorParallel.place_tensor`` of the UNet and the DiT). Its collectives
take the tensors as they are, CUDA ones included, over gloo or NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


def _all_gather(x: torch.Tensor, where: "TensorGroup") -> torch.Tensor:
    """The group's shards of ``x`` concatenated along the last axis, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(where.size)]
    dist.all_gather(parts, x, group=where.group)
    return torch.cat(parts, dim=-1)


def _reduce_scatter(g: torch.Tensor, where: "TensorGroup") -> torch.Tensor:
    """This rank's slice along the last axis of ``g`` summed over the group."""
    chunks = [c.contiguous() for c in g.chunk(where.size, dim=-1)]
    out = torch.empty_like(chunks[where.index])
    dist.reduce_scatter(out, chunks, group=where.group)
    return out


class Gather(torch.autograd.Function):
    """A channel shard → the whole tensor on every rank of the group; the
    backward sums the ranks' partial gradients and keeps this rank's slice
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, where: "TensorGroup") -> torch.Tensor:
        ctx.where = where
        return _all_gather(x, where)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _reduce_scatter(grad, ctx.where), None


class ToPartial(torch.autograd.Function):
    """The identity, whose backward divides by the group's size: a whole
    output that every rank computes alike, made into the partial sums of
    the gradient convention."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: int) -> torch.Tensor:
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad / ctx.size, None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorGroup:
    """Where a model's channels live on a ``tensor`` mesh axis: the process
    group of the ``size`` ranks that share a batch slice (None: the world)
    and this rank's place ``index`` in it (it holds channels
    [index·C/size, (index+1)·C/size) of each split tensor)."""

    group: Any
    size: int
    index: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(…, C/T) → (…, C) on every rank (:class:`Gather`)."""
        return Gather.apply(x, self)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """(…, C) → this rank's (…, C/T); the backward pads with zeros."""
        return x.chunk(self.size, dim=-1)[self.index]

    def to_partial(self, x: torch.Tensor) -> torch.Tensor:
        """:class:`ToPartial`."""
        return ToPartial.apply(x, self.size)

    def gather_cat(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``cat([gather(a), gather(b)], -1)`` in one all-gather: the
        shards go together and come back rank-major, then regroup."""
        n = a.shape[-1]
        both = self.gather(torch.cat([a, b], dim=-1)).unflatten(-1, (self.size, -1))
        return torch.cat([both[..., :n].flatten(-2), both[..., n:].flatten(-2)], dim=-1)
