"""The train step (mirrors ``dmme_tpu/parallel/train_step.py``, one device).

JAX compiles the step with ``jit`` and donates the state; here the step
runs eagerly and updates the state in place (see
:mod:`dmme_tpu_torch.training.state`). A loss function is
``loss_fn(params, generator, batch) -> scalar``; every random draw of a
step comes from one ``torch.Generator`` on the batch's device, seeded from
the run seed and the state's step, as ``fold_in(rng, state.step)`` seeds
JAX's, so a resumed run can reproduce the stream.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch

LossFn = Callable[[Dict[str, torch.Tensor], torch.Generator, Any], torch.Tensor]


def _device(batch) -> torch.device:
    return (batch[0] if isinstance(batch, (tuple, list)) else batch).device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of the run seeded ``seed``: its seed
    mixes both numbers (numpy's SeedSequence), so neighbouring steps and
    neighbouring runs get unrelated streams."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed & ((1 << 63) - 1))


def make_train_step(loss_fn: LossFn, debug_nans: bool = False):
    """``step(state, batch, seed) -> (state, metrics)``: the loss and its
    gradient with respect to every parameter, one optimizer step in place,
    and the metrics ``loss`` and ``grad_norm`` (the norm before clipping) as
    0-dim tensors on the device, read by the caller when it logs. A
    ``loss_fn`` marked ``is_grad_fn`` returns ``(loss, grads)`` itself
    (gradient accumulation). With ``debug_nans`` the step reads both
    metrics and raises ``FloatingPointError``, before the update, where one
    is not finite."""
    is_grad_fn = getattr(loss_fn, "is_grad_fn", False)

    def step(state, batch, seed: int):
        generator = step_generator(seed, state.step, _device(batch))
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        if is_grad_fn:
            loss, grads = loss_fn(params, generator, batch)
        else:
            with torch.enable_grad():
                loss = loss_fn(params, generator, batch)
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}
        if debug_nans and not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise FloatingPointError(
                f"step {state.step + 1}: loss {float(metrics['loss'])}, grad_norm "
                f"{float(metrics['grad_norm'])} (debug_nans; the state is not updated)")
        state.apply_gradients(grads)
        return state, metrics

    return step


def make_train_chunk(loss_fn: LossFn, steps: int, debug_nans: bool = False):
    """``chunk(state, batches, seed) -> (state, metrics)`` over ``batches``
    stacked on a leading axis of length ``steps``: the steps in order, with
    each metric stacked likewise. JAX scans the steps inside one program;
    here it is a Python loop over the same step."""
    step = make_train_step(loss_fn, debug_nans)

    def chunk(state, batches, seed: int):
        if isinstance(batches, (tuple, list)):
            per_step = [tuple(b[i] for b in batches) for i in range(steps)]
        else:
            per_step = [batches[i] for i in range(steps)]
        metrics = []
        for batch in per_step:
            state, m = step(state, batch, seed)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return chunk


def make_eval_step(loss_fn: LossFn):
    """``step(params, batch, generator) -> loss`` with no gradient and no update."""

    def step(params, batch, generator: torch.Generator):
        with torch.no_grad():
            return loss_fn(params, generator, batch)

    return step


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """ℓ2 norm over all elements of all tensors, in f32, on their device."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))
