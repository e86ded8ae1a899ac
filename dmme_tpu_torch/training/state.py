"""Train state: everything a training step mutates (mirrors ``dmme_tpu/training/state.py``).

{step, params, ema_params, opt_state} with the optimizer and the EMA
settings beside them. JAX returns a new state from each step and donates
the old one; here the step updates the tensors in place, under
``torch.no_grad()``. An in-place update bumps each tensor's version
counter, which is what the fused ResBlock kernel's weight cache
(:func:`dmme_tpu_torch.ops.resblock.pack_weights`) keys on, so sampling
after a step reads the new weights. ``torch.inference_mode()`` would not
bump it, and must not be used for the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

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

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: ClipAdam, ema_decay: float = 0.9999,
               ema_every_n_steps: int = 1) -> "TrainState":
        """Step 0, the EMA copy equal to ``params``, the optimizer state zero."""
        return cls(step=0, params=dict(params),
                   ema_params={k: v.clone() for k, v in params.items()},
                   opt_state=tx.init(params), tx=tx, ema_decay=ema_decay,
                   ema_every_n_steps=ema_every_n_steps)

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        """One optimizer step and the EMA after it, in place; returns self."""
        self.tx.update_(grads, self.opt_state, self.params)
        if self.ema_every_n_steps <= 1 or (self.step + 1) % self.ema_every_n_steps == 0:
            ema_update(self.ema_params, self.params, self.ema_decay)
        self.step += 1
        return self

    def to(self, device) -> "TrainState":
        """A copy on ``device`` (the same tensors where they already live there)."""
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return dataclasses.replace(self, params=move(self.params),
                                   ema_params=move(self.ema_params),
                                   opt_state=self.opt_state.to(device))
