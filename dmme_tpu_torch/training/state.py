"""Train state: everything a training step mutates (mirrors ``dmme_tpu/training/state.py``).

{step, params, ema_params, opt_state} with the optimizer and the EMA
settings beside them, and, after ``parallel.shard_state``, the mesh and the
axis each split leaf is split along, on the ``fsdp``, ``expert`` and
``tensor`` mesh axes: its parameters, EMA and moments are then this rank's
shards (:meth:`TrainState.whole` gathers them); the ``spatial`` axis splits
no leaf, so on it every rank holds the whole state. JAX
returns a new state from each step and donates the old one; here the step
updates the tensors in place, under
``torch.no_grad()``. An in-place update bumps each tensor's version
counter, which is what the fused ResBlock kernel's weight cache
(:func:`dmme_tpu_torch.ops.resblock.pack_weights`) keys on, so sampling
after a step reads the new weights. ``torch.inference_mode()`` would not
bump it, and must not be used for the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from dmme_tpu_torch.parallel.mesh import gather_leaves
from dmme_tpu_torch.training.ema import ema_update
from dmme_tpu_torch.training.optimizer import ClipAdam


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: Any
    tx: ClipAdam
    ema_decay: float = 0.9999
    #: update the moving average only every N optimizer steps
    ema_every_n_steps: int = 1
    #: the mesh the state is laid out on (``parallel.shard_state``), or None
    mesh: Any = None
    #: {name: axis} of the leaves held as this rank's fsdp shard
    shard_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: {name: axis} of the MoE stacks held as this rank's expert shard
    expert_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: {name: axis} of the kernels held as this rank's tensor (column) shard
    tensor_axes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def sharded(self) -> bool:
        """Whether this rank holds shards of some leaves."""
        return bool(self.shard_axes or self.expert_axes or self.tensor_axes)

    @property
    def split(self) -> Dict[str, Dict[str, int]]:
        """{mesh axis: {name: axis}} of the split leaves."""
        return {"fsdp": self.shard_axes, "expert": self.expert_axes, "tensor": self.tensor_axes}

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: ClipAdam, ema_decay: float = 0.9999,
               ema_every_n_steps: int = 1) -> "TrainState":
        """Step 0, the EMA copy equal to ``params``, the optimizer state zero."""
        return cls(step=0, params=dict(params),
                   ema_params={k: v.clone() for k, v in params.items()},
                   opt_state=tx.init(params), tx=tx, ema_decay=ema_decay,
                   ema_every_n_steps=ema_every_n_steps)

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        norm: Optional[torch.Tensor] = None) -> "TrainState":
        """One optimizer step and the EMA after it, in place; returns self.
        ``norm``: the gradients' global norm, which fsdp shards cannot give."""
        if norm is None:
            self.tx.update_(grads, self.opt_state, self.params)
        else:
            self.tx.update_(grads, self.opt_state, self.params, norm)
        if self.ema_every_n_steps <= 1 or (self.step + 1) % self.ema_every_n_steps == 0:
            ema_update(self.ema_params, self.params, self.ema_decay)
        self.step += 1
        return self

    def whole(self, moments: bool = True) -> "TrainState":
        """This state with every shard gathered whole, off the mesh: with
        shards a collective that every rank calls (the fsdp shards, then the
        expert and the tensor shards); else the state itself. Without
        ``moments`` the copy has no optimizer state (to sample)."""
        if not self.sharded:
            return self

        def full(d):
            d = dict(d, **gather_leaves(self.mesh, d, self.shard_axes))
            d = dict(d, **gather_leaves(self.mesh, d, self.expert_axes, "expert"))
            return dict(d, **gather_leaves(self.mesh, d, self.tensor_axes, "tensor"))

        opt = None
        if moments:
            opt = dataclasses.replace(self.opt_state, mu=full(self.opt_state.mu),
                                      nu=full(self.opt_state.nu))
        return dataclasses.replace(self, params=full(self.params),
                                   ema_params=full(self.ema_params), opt_state=opt,
                                   mesh=None, shard_axes={}, expert_axes={}, tensor_axes={})

    def to(self, device) -> "TrainState":
        """A copy on ``device`` (the same tensors where they already live there)."""
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return dataclasses.replace(self, params=move(self.params),
                                   ema_params=move(self.ema_params),
                                   opt_state=self.opt_state.to(device))
