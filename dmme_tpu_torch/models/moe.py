"""Mixture-of-Experts FFN: token-choice top-k routing with a static capacity
(mirrors ``dmme_tpu/models/moe.py``; Shazeer et al. 2017, GShard, Switch).

Routing is the JAX package's one-hot form: a (tokens, experts, capacity)
combine tensor built from the chosen experts and each token's position in
its expert's queue, ``dispatch = combine > 0``, and the experts' FFNs as
three einsums over the capacity axis. Tokens past an expert's capacity get
a zero one-hot row (``jax.nn.one_hot`` of an index out of range) and reach
the output only through the block's residual path.

In training the router's logits take exploration noise (``router_noise``
times the standard-normal draw the caller hands in) and the selection is
balanced by ``sinkhorn_iters`` rounds of Sinkhorn normalisation, with a
self-labelling cross-entropy toward it (``moe_align``). The gates come from
the raw softmax in every mode. The router runs in f32 whatever the compute
dtype.

:meth:`MoEMlp.forward` returns the output and the call's router statistics,
``{"moe_aux", "moe_align" (training with Sinkhorn only), "moe_z", "f_e"}``;
the layer keeps nothing between calls. The harnesses add ``moe_aux`` and
``moe_align`` at ``moe_aux_weight`` and ``moe_z`` at ``moe_z_weight``;
``f_e`` (the round-1 routed fraction per expert) is a diagnostic only.
Parameters keep flax's names and layouts: ``router`` (a Dense), ``w_in``
(E, d, f), ``b_in`` (E, 1, f), ``w_out`` (E, f, d), ``b_out`` (E, 1, d).

Expert parallelism (the mesh's ``expert`` axis, GShard): where
``parallel.shard_state`` splits the stacks over an expert group of P ranks,
it hands each layer its :class:`ExpertGroup` (:func:`place_experts`), and a
forward that is given a rank's (E/P, …) shards of ``w_in``/``w_out`` routes
its own tokens exactly as above (its own capacity, balance and statistics),
sends each expert's (C, d) queue to the rank that holds the expert and gets
the group's queues for its own E/P experts (an all-to-all,
:class:`AllToAll`, whose backward is the reverse all-to-all), runs those
experts on (E/P, P·C, d), and sends the outputs back by a second all-to-all
before the combine. Given whole stacks the layer issues no collective.

Tensor parallelism (the mesh's ``tensor`` axis, in a tensor-split DiT):
JAX's rule splits ``w_in`` (E, d, f) on f and ``w_out`` (E, f, d) on d, and
the ``router`` and the biases too once they reach its size threshold. The
layer takes the whole input, alike on every rank of the tensor group, so
the group routes alike, bitwise (a router bound as a column shard has its
logits gathered whole). Each expert's hidden layer runs on ``w_in``'s
columns with the rank's slice of ``b_in`` and is all-gathered along f
before ``w_out``, whose columns give the rank's slice of d (with that slice
of ``b_out``); the combine then returns the rank's (N, T, d/T) channels.
With both axes a stack is split on E first, then on its last axis
(``('expert', None, 'tensor')``): the all-to-alls run within the ranks of
one tensor index, which hold the same columns of their experts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dmme_tpu_torch.models.blocks import Dense, _lecun_normal_, whole_output


@dataclasses.dataclass(frozen=True, eq=False)
class ExpertGroup:
    """Where a layer's experts live on an ``expert`` mesh axis: the process
    group of the ``size`` ranks that exchange their tokens (None: the
    world) and this rank's place ``index`` in it (it holds experts
    [index·E/size, (index+1)·E/size))."""

    group: Any
    size: int
    index: int


def _exchange(x: torch.Tensor, where: ExpertGroup) -> torch.Tensor:
    """Chunk i of ``x``'s leading axis to rank i of the group, chunk j of
    the result from rank j (one all-to-all of equal splits, on the tensors
    as they are: NCCL and gloo both take CUDA tensors)."""
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=where.group)
    return out


class AllToAll(torch.autograd.Function):
    """:func:`_exchange` with the reverse exchange as its backward (an
    all-to-all of equal splits is its own transpose)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, where: ExpertGroup) -> torch.Tensor:
        ctx.where = where
        return _exchange(x, where)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _exchange(grad, ctx.where), None


def place_experts(model: nn.Module, where: Optional[ExpertGroup]) -> None:
    """Hand every :class:`MoEMlp` of ``model`` its expert group (None: the
    stacks are whole)."""
    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.expert_group = where


class MoEMlp(nn.Module):
    """Drop-in replacement for a transformer FFN: (N, T, d) → (N, T, d).

    Each expert takes at most ``ceil(tokens · top_k / E · capacity_factor)``
    tokens a call (and no more than the tokens there are).
    """

    #: the ``TensorGroup`` of a tensor-split model (``TensorParallel.place_tensor``)
    tensor_group = None

    def __init__(self, dim: int, num_experts: int, mlp_dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25, router_noise: float = 1.0,
                 sinkhorn_iters: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        assert 1 <= top_k <= num_experts, (top_k, num_experts)
        self.num_experts, self.mlp_dim, self.top_k = num_experts, mlp_dim, top_k
        self.capacity_factor, self.router_noise = capacity_factor, router_noise
        self.sinkhorn_iters, self.dtype = sinkhorn_iters, dtype
        self.router = Dense(dim, num_experts, torch.float32)
        self.w_in = nn.Parameter(torch.empty(num_experts, dim, mlp_dim))
        self.b_in = nn.Parameter(torch.zeros(num_experts, 1, mlp_dim))
        self.w_out = nn.Parameter(torch.empty(num_experts, mlp_dim, dim))
        self.b_out = nn.Parameter(torch.zeros(num_experts, 1, dim))
        #: where the experts live when the stacks are split (:func:`place_experts`)
        self.expert_group: Optional[ExpertGroup] = None

    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's init of the expert stacks: ``lecun_normal`` over (E, d_in,
        d_out), whose fan-in counts the expert axis (E · d_in), zero biases.
        The router is a :class:`Dense`, drawn by ``init_weights``."""
        e = self.num_experts
        _lecun_normal_(self.w_in, generator, e * self.w_in.shape[1])
        _lecun_normal_(self.w_out, generator, e * self.w_out.shape[1])
        self.b_in.zero_()
        self.b_out.zero_()

    def capacity(self, tokens: int) -> int:
        return min(max(1, math.ceil(tokens * self.top_k / self.num_experts
                                    * self.capacity_factor)), tokens)

    def route(self, logits: torch.Tensor, train: bool):
        """(probs, masks, gates, stats) of the f32 router ``logits`` (S, E):
        the softmax, each round's one-hot choice (S, E) and gate (S,), and
        ``moe_align`` in ``stats`` where training balances the selection."""
        e, k = self.num_experts, self.top_k
        probs = torch.softmax(logits, dim=-1)
        stats: Dict[str, torch.Tensor] = {}
        sel = probs
        if train and self.sinkhorn_iters > 0:
            with torch.no_grad():
                sel = probs.detach()
                for _ in range(self.sinkhorn_iters):
                    sel = sel / (torch.sum(sel, dim=0, keepdim=True) + 1e-9)
                    sel = sel / (torch.sum(sel, dim=1, keepdim=True) + 1e-9)
            stats["moe_align"] = -torch.mean(
                torch.sum(sel * torch.log_softmax(logits, dim=-1), dim=-1))

        # top-k token-choice assignment, one round per k; argmax takes the
        # first maximum, as jnp.argmax does
        remaining = sel
        masks, gates = [], []
        for _ in range(k):
            mask = F.one_hot(torch.argmax(remaining, dim=-1), e).to(torch.float32)
            gates.append(torch.sum(probs * mask, dim=-1))
            masks.append(mask)
            remaining = remaining * (1.0 - mask)
        if k > 1:  # GShard: the chosen gates renormalised to sum to 1
            denom = sum(gates) + 1e-9
            gates = [g / denom for g in gates]
        return probs, masks, gates, stats

    def combine_weights(self, masks, gates, capacity: int) -> torch.Tensor:
        """The (S, E, capacity) f32 combine tensor of the rounds' choices and
        gates: each token's gate at its position in its expert's queue,
        round-2 tokens queued behind round-1 occupants; a token past the
        capacity gets a zero row (``jax.nn.one_hot`` of an index out of
        range)."""
        s, e = masks[0].shape
        device = masks[0].device
        slots = torch.arange(capacity, device=device, dtype=torch.float32)
        combine = torch.zeros((s, e, capacity), device=device, dtype=torch.float32)
        kept_counts = torch.zeros((e,), device=device, dtype=torch.float32)
        for mask, gate in zip(masks, gates):
            pos = torch.cumsum(mask, dim=0) - 1.0 + kept_counts[None, :]
            pos = torch.sum(pos * mask, dim=-1)
            kept = (pos < capacity).to(torch.float32) * torch.sum(mask, dim=-1)
            kept_counts = kept_counts + torch.sum(mask * kept[:, None], dim=0)
            pos_oh = (pos[:, None] == slots).to(torch.float32)
            combine = combine + (gate * kept)[:, None, None] * (mask[:, :, None]
                                                                * pos_oh[:, None, :])
        return combine

    def _split(self) -> Optional[ExpertGroup]:
        """The expert group where the bound ``w_in`` is a rank's shard of
        the stack, None where it is whole."""
        held = self.w_in.shape[0]
        if held == self.num_experts:
            return None
        where = self.expert_group
        if where is None or held * where.size != self.num_experts:
            raise ValueError(f"w_in holds {held} of {self.num_experts} experts, but the layer's "
                             f"expert group is {where}: lay the state out with "
                             "parallel.shard_state(..., model=)")
        return where

    def _local(self, b: torch.Tensor, where: ExpertGroup) -> torch.Tensor:
        """This rank's experts' rows of a bias held whole (or already a shard)."""
        local = self.num_experts // where.size
        return b if b.shape[0] == local else b[where.index * local:(where.index + 1) * local]

    def _columns(self, b: torch.Tensor, width: int) -> torch.Tensor:
        """A bias for an output of ``width`` columns: as it is, or the rank's
        slice of it held whole where the kernel is a column shard."""
        return b if b.shape[-1] == width else self.tensor_group.shard(b)

    def _experts(self, h: torch.Tensor, b_in: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
        """The bound experts' FFNs on their (E', tokens, d) queues: (E',
        tokens, d), or the rank's d/T where ``w_out`` is a column shard (the
        hidden layer of a column shard of ``w_in`` gathered whole first)."""
        h = torch.einsum("ecd,edf->ecf", h, self.w_in.to(self.dtype))
        h = F.gelu(h + self._columns(b_in, h.shape[-1]).to(self.dtype), approximate="tanh")
        if h.shape[-1] != self.mlp_dim:
            h = self.tensor_group.gather(h)
        out = torch.einsum("ecf,efd->ecd", h, self.w_out.to(self.dtype))
        return out + self._columns(b_out, out.shape[-1]).to(self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(output, router statistics). ``train``: Sinkhorn-balanced
        selection, and the caller's (S, E) standard-normal ``noise`` on the
        router's logits at ``router_noise`` where it drew one (JAX adds it
        only with a dropout stream). The output is the rank's d/T channels
        where ``w_out`` is a tensor group's column shard."""
        n, t, d = x.shape
        e, s = self.num_experts, n * t
        xs = x.reshape(s, d)

        logits = whole_output(self.router, xs.to(torch.float32))
        if train and self.router_noise > 0 and noise is not None:
            logits = logits + self.router_noise * noise.to(device=logits.device,
                                                           dtype=torch.float32)
        probs, masks, gates, stats = self.route(logits, train)
        combine = self.combine_weights(masks, gates, self.capacity(s))
        dispatch = (combine > 0.0).to(self.dtype)  # a gate of exactly 0 dispatches nothing

        expert_in = torch.einsum("sec,sd->ecd", dispatch, xs.to(self.dtype))
        where = self._split()
        if where is None:
            out = self._experts(expert_in, self.b_in, self.b_out)
        else:  # the queues to their experts' ranks, the experts, and back
            p, c, local = where.size, expert_in.shape[1], e // where.size
            got = AllToAll.apply(expert_in, where)  # (P·E/P, C, d): block i from rank i
            got = got.reshape(p, local, c, d).transpose(0, 1).reshape(local, p * c, d)
            out = self._experts(got, *(self._local(b, where) for b in (self.b_in, self.b_out)))
            out = out.reshape(local, p, c, -1).transpose(0, 1)
            out = AllToAll.apply(out, where).reshape(e, c, -1)
        y = torch.einsum("sec,ecd->sd", combine.to(self.dtype), out)

        # Switch aux E·Σ f_e·P_e (round-1 routed fraction, mean prob), the
        # raw router z-loss, and f_e itself (a diagnostic, never summed)
        f_e = torch.mean(masks[0], dim=0)
        stats["moe_aux"] = e * torch.sum(f_e * torch.mean(probs, dim=0))
        stats["moe_z"] = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        stats["f_e"] = f_e
        return y.reshape(n, t, -1), stats
