"""``fit``: the training loop (mirrors ``dmme_tpu/training/loop.py``, one process).

seed → (init, run) generators → ``lit.init_state`` → ``train_iter(seed)`` →
``make_train_step`` (or ``make_train_chunk`` for ``steps_per_call > 1``) →
the loop, which logs loss, grad_norm, imgs_per_sec and lr every
``log_every`` steps and reads the device only then. Checkpoints, restarts,
callbacks, extra loggers, gradient accumulation and meshes are not ported
yet: their arguments raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from dmme_tpu_torch.parallel.train_step import make_train_chunk, make_train_step
from dmme_tpu_torch.training.metrics import MetricLogger
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.device import resolve_device


def _not_ported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"fit({name}=...) is not ported yet (ROADMAP {item})")


def fit(
    lit,
    datamodule,
    max_steps: int,
    *,
    max_restarts: int = 0,
    resume: bool = False,
    seed: int = 1337,
    mesh=None,
    log_every: int = 50,
    ckpt_dir: Optional[str] = None,
    callbacks: Sequence[Any] = (),
    state: Optional[TrainState] = None,
    accumulate_grad_batches: int = 1,
    steps_per_call: int = 1,
    debug_nans: bool = False,
    loggers=None,
    tensorboard: bool = False,
    device=None,
) -> TrainState:
    """Train ``lit`` on ``datamodule`` until ``state.step == max_steps``.

    Defaults mirror the JAX package: seed 1337, a log line every 50 steps.
    ``state`` continues a given state (its step counts toward ``max_steps``
    and selects the step generators). ``device=None`` means the CUDA
    device and raises without one; the tests pass ``device="cpu"``.
    """
    for name, value, item in (("ckpt_dir", ckpt_dir, "A.7"), ("resume", resume, "A.7"),
                              ("max_restarts", max_restarts, "A.7"),
                              ("callbacks", tuple(callbacks), "A.7"),
                              ("loggers", loggers, "A.7"), ("tensorboard", tensorboard, "A.7"),
                              ("debug_nans", debug_nans, "A.7"), ("mesh", mesh, "A.16")):
        if value:
            raise _not_ported(name, item)
    if accumulate_grad_batches > 1:
        raise _not_ported("accumulate_grad_batches", "A.7")
    device = resolve_device(device)

    datamodule.prepare_data()
    datamodule.setup("fit")
    seq = np.random.SeedSequence(seed)
    init_seed, run_seed = (int(s.generate_state(1, np.uint64)[0] >> 1) for s in seq.spawn(2))
    if state is None:
        state = lit.init_state(torch.Generator().manual_seed(init_seed), device=device)

    loss_fn = lit.make_loss_fn(datamodule)
    train_step = (make_train_chunk(loss_fn, steps_per_call) if steps_per_call > 1
                  else make_train_step(loss_fn))
    logger = MetricLogger()
    try:
        return _train_loop(lit, state, max_steps, datamodule.train_iter(seed), train_step,
                           loss_fn, run_seed, steps_per_call, log_every, logger, device)
    finally:
        logger.close()


def _place(batch, device):
    """A numpy batch (or tuple of them) as tensors on ``device``; through
    pinned memory on a CUDA device, so the copy does not wait for the
    kernels already queued."""
    if isinstance(batch, tuple):
        return tuple(_place(b, device) for b in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _stack(batches):
    if isinstance(batches[0], tuple):
        return tuple(np.stack(parts) for parts in zip(*batches))
    return np.stack(batches)


def _train_loop(lit, state, max_steps, it, train_step, loss_fn, run_seed, steps_per_call,
                log_every, logger, device):
    step = state.step
    t_last, imgs_since = time.time(), 0
    while step < max_steps:
        stride = min(steps_per_call, max_steps - step)
        if steps_per_call > 1:
            if stride != steps_per_call:  # a tail shorter than a chunk runs step by step
                break
            batch = _place(_stack([next(it) for _ in range(stride)]), device)
        else:
            batch = _place(next(it), device)
        state, metrics = train_step(state, batch, run_seed)
        if steps_per_call > 1:
            metrics = {k: v[-1] for k, v in metrics.items()}
        lead = batch[0] if isinstance(batch, tuple) else batch
        imgs_since += int(np.prod(lead.shape[:-3]))  # (..., H, W, C) leading dims
        step += stride

        if step % log_every < stride:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the device
            now = time.time()
            m["imgs_per_sec"] = imgs_since / max(now - t_last, 1e-9)
            m["lr"] = lit.lr * min(1.0, step / max(lit.warmup, 1))
            t_last, imgs_since = now, 0
            logger.log(step, m)

    if step < max_steps:
        single = make_train_step(loss_fn)
        while step < max_steps:
            state, _ = single(state, _place(next(it), device), run_seed)
            step += 1
    return state
