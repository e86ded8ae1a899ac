"""The JAX package's optimizer chain in torch ops (``dmme_tpu/training/lit.py:105-108``).

``optax.chain(clip_by_global_norm(max_norm), adam(schedule))`` written out,
not ``torch.optim``: the two differ where it matters for parity.

1. Clip by the global norm optax's way: ``g·(max_norm/‖g‖)`` when
   ‖g‖ ≥ max_norm, else ``g`` (no ``+1e-6`` in the divisor, unlike
   ``torch.nn.utils.clip_grad_norm_``).
2. Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root, the
   moments bias-corrected on count + 1.
3. With ``weight_decay`` (``optax.adamw``'s, no mask): ``weight_decay·p``
   added to Adam's update before the scaling, so it reaches every parameter.
4. The step scaled by ``-schedule(count)``, the count before its increment.

The state updates in place under ``torch.no_grad()`` with multi-tensor
``torch._foreach_*`` ops, a few launches per step for all tensors together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from dmme_tpu_torch.parallel.train_step import global_norm


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` (the schedule's count is the same number)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def to(self, device) -> "AdamState":
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return AdamState(self.count, move(self.mu), move(self.nu))


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """Global-norm clip, then Adam (AdamW with ``weight_decay``) at a
    scheduled learning rate."""

    max_norm: float
    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update_(self, grads: Dict[str, torch.Tensor], state: AdamState,
                params: Dict[str, torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """One step: ``params`` and ``state`` change in place; ``grads``
        (keyed as ``params``) are read only. ``norm``: the gradients' global
        norm where the caller has it (under fsdp ``grads`` are shards, and
        the norm of the whole takes a collective)."""
        keys = list(params)
        g = [grads[k] for k in keys]
        if norm is None:
            norm = global_norm(g)
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        g = torch._foreach_mul(g, factor)
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state.count + 1
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        lr = self.schedule(state.count)
        if self.weight_decay:  # p − lr·(adam + wd·p), the decay on the p before the step
            torch._foreach_mul_([params[k] for k in keys], 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_([params[k] for k in keys], mu, denom, value=-lr / bc1)
        state.count = count
