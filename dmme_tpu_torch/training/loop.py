"""``fit``: the training loop (mirrors ``dmme_tpu/training/loop.py``, one process).

seed → (init, run) seeds → ``lit.init_state`` (or the latest checkpoint,
with ``resume``) → ``train_iter(seed)`` fast-forwarded past the batches the
restored steps consumed → ``make_train_step`` (or ``make_train_chunk`` for
``steps_per_call > 1``) → the loop, which logs loss, grad_norm, imgs_per_sec
and lr every ``log_every`` steps and reads the device only then, saves a
checkpoint every ``ckpt_every`` steps and at the end, and calls the
callbacks' hooks. Every draw of step k comes from a generator keyed on (run
seed, k) (:func:`~dmme_tpu_torch.parallel.train_step.step_generator`), so a
resumed or restarted run is bitwise the uninterrupted one.

The state updates in place (JAX returns a new one). A step interrupted
inside its update leaves a torn state, so an interrupt saves a checkpoint
only at a safe point between steps: SIGTERM (preemption) and a first
Ctrl-C are deferred to the next one, and a ``KeyboardInterrupt`` raised
inside a step saves nothing. Meshes are not ported: ``mesh`` raises
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import inspect
import os
import signal
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dmme_tpu_torch.parallel.train_step import (make_train_chunk, make_train_step,
                                                step_generator)
from dmme_tpu_torch.training.checkpoint import CheckpointManager
from dmme_tpu_torch.training.metrics import MetricLogger
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.device import resolve_device


def fit(lit, datamodule, max_steps: int, *, max_restarts: int = 0, resume: bool = False,
        **kwargs) -> TrainState:
    """Train ``lit`` on ``datamodule`` until the state reaches ``max_steps``.

    See :func:`_fit_once` for the keywords. ``max_restarts``: on an
    exception other than ``KeyboardInterrupt``, restore the latest checkpoint
    and go on, up to that many times (needs ``ckpt_dir``).
    """
    if max_restarts <= 0:
        return _fit_once(lit, datamodule, max_steps, resume=resume, **kwargs)
    if not kwargs.get("ckpt_dir"):
        raise ValueError("max_restarts needs ckpt_dir to recover from")
    attempts = 0
    while True:
        try:
            return _fit_once(lit, datamodule, max_steps, resume=resume or attempts > 0,
                             **kwargs)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — the recovery boundary
            attempts += 1
            if attempts > max_restarts:
                raise
            print(f"[fit] attempt {attempts}/{max_restarts} failed ({type(e).__name__}: {e}); "
                  "restoring the latest checkpoint and resuming", flush=True)


def _fit_once(
    lit,
    datamodule,
    max_steps: int,
    *,
    seed: int = 1337,
    mesh=None,
    log_every: int = 50,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100_000,
    ckpt_max_to_keep: Optional[int] = 3,
    callbacks: Sequence[Any] = (),
    state: Optional[TrainState] = None,
    resume: bool = False,
    accumulate_grad_batches: int = 1,
    steps_per_call: int = 1,
    debug_nans: bool = False,
    loggers=None,
    tensorboard: bool = False,
    device=None,
) -> TrainState:
    """One attempt of :func:`fit`.

    Defaults mirror the JAX package: seed 1337, a log line every 50 steps, a
    checkpoint every 100k steps and at the end. ``state`` continues a given
    state (its step counts toward ``max_steps``). ``accumulate_grad_batches
    = k`` sums the gradients of k microbatches a step; ``steps_per_call``
    runs steps in chunks, and the cadences snap to chunk ends; the two
    exclude each other. ``debug_nans`` stops with ``FloatingPointError`` at
    the first step whose loss or gradient is not finite, before its update.
    ``ckpt_dir`` also holds ``metrics.jsonl`` (and ``tb/`` with
    ``tensorboard``); ``loggers`` replaces those backends. ``device=None``
    means the CUDA device and raises without one; the tests pass
    ``device="cpu"``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "fit(mesh=...) is not ported yet (ROADMAP A.11, distribution; old A.16)")
    if steps_per_call > 1 and accumulate_grad_batches > 1:
        raise ValueError("steps_per_call and accumulate_grad_batches exclude each other")
    device = resolve_device(device)

    datamodule.prepare_data()
    datamodule.setup("fit")
    seq = np.random.SeedSequence(seed)
    init_seed, run_seed = (int(s.generate_state(1, np.uint64)[0] >> 1) for s in seq.spawn(2))
    if state is None:
        state = lit.init_state(torch.Generator().manual_seed(init_seed), device=device)

    ckpt = CheckpointManager(ckpt_dir, max_to_keep=ckpt_max_to_keep) if ckpt_dir else None
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(state)

    loss_fn = lit.make_loss_fn(datamodule)
    if accumulate_grad_batches > 1:
        loss_fn = _microbatched(loss_fn, accumulate_grad_batches)
    if steps_per_call > 1:
        train_step = make_train_chunk(loss_fn, steps_per_call, debug_nans=debug_nans)
    else:
        train_step = make_train_step(loss_fn, debug_nans=debug_nans)

    logger = MetricLogger(ckpt_dir, tensorboard=tensorboard, loggers=loggers)
    for cb in callbacks:
        _call(cb, "on_fit_start", lit=lit, state=state, logger=logger)

    # resume determinism: skip the batches the restored steps consumed
    it = datamodule.train_iter(seed, skip_batches=state.step * max(accumulate_grad_batches, 1))

    # what an interrupt handler may save: the state, and whether it is whole
    # (False while a step updates it in place)
    holder = {"state": state, "whole": True, "preempted": False, "interrupted": False}
    restore = _install_handlers(holder)
    try:
        try:
            state = _train_loop(lit, holder, max_steps, it, train_step, loss_fn, run_seed,
                                steps_per_call, accumulate_grad_batches, log_every, ckpt,
                                ckpt_every, callbacks, logger, device, debug_nans)
            if ckpt is not None and ckpt.latest_step() != state.step:
                ckpt.save(state.step, state, force=True)  # save-last
            for cb in callbacks:
                _call(cb, "on_fit_end", lit=lit, state=state, logger=logger)
        except KeyboardInterrupt:
            if ckpt is not None and holder["whole"]:
                done = holder["state"]
                if ckpt.latest_step() != done.step:
                    ckpt.save(done.step, done, force=True)
                print(f"[fit] interrupted: saved step {done.step}", flush=True)
            elif ckpt is not None:
                print("[fit] interrupted inside a step: the state may be torn, nothing "
                      "saved", flush=True)
            if holder["preempted"]:
                restore()
                os.kill(os.getpid(), signal.SIGTERM)  # die by SIGTERM, as preempted
            raise
        # a signal that came after the last safe point: everything is saved
        if holder["preempted"]:
            restore()
            os.kill(os.getpid(), signal.SIGTERM)
        if holder["interrupted"]:
            raise KeyboardInterrupt
    finally:
        restore()
        logger.close()
    return state


def _install_handlers(holder) -> Callable[[], None]:
    """Defer SIGTERM and a first SIGINT to the loop's next safe point (a
    second SIGINT interrupts at once). Main thread only. Returns the
    function that puts the previous handlers back."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def on_sigterm(signum, frame):
        holder["preempted"] = True

    def on_sigint(signum, frame):
        if holder["interrupted"]:
            raise KeyboardInterrupt
        holder["interrupted"] = True

    previous = {}
    for sig, handler in ((signal.SIGTERM, on_sigterm), (signal.SIGINT, on_sigint)):
        try:
            previous[sig] = signal.signal(sig, handler)
        except ValueError:
            pass

    def restore():
        while previous:
            sig, old = previous.popitem()
            # None: installed from C, not representable here; the default then
            signal.signal(sig, signal.SIG_DFL if old is None else old)

    return restore


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


def _step(holder, train_step, batch, run_seed):
    """One train step (or chunk) on the held state, marked torn while it
    runs; then the safe point, where a deferred signal interrupts."""
    holder["whole"] = False
    state, metrics = train_step(holder["state"], batch, run_seed)
    holder["state"], holder["whole"] = state, True
    if holder["preempted"] or holder["interrupted"]:
        raise KeyboardInterrupt
    return state, metrics


def _train_loop(lit, holder, max_steps, it, train_step, loss_fn, run_seed, steps_per_call,
                accumulate_grad_batches, log_every, ckpt, ckpt_every, callbacks, logger,
                device, debug_nans):
    state = holder["state"]
    step = state.step
    t_last, imgs_since = time.time(), 0
    while step < max_steps:
        stride = min(steps_per_call, max_steps - step)
        if steps_per_call > 1:
            if stride != steps_per_call:  # a tail shorter than a chunk runs step by step
                break
            batch = _stack([next(it) for _ in range(stride)])
        elif accumulate_grad_batches > 1:
            batch = _stack([next(it) for _ in range(accumulate_grad_batches)])
        else:
            batch = next(it)
        batch = _place(batch, device)
        state, metrics = _step(holder, train_step, batch, run_seed)
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
            for cb in callbacks:
                _call(cb, "on_log", step=step, lit=lit, state=state, metrics=m, logger=logger)

        if ckpt is not None and step % ckpt_every < stride:
            ckpt.save(step, state)

        for cb in callbacks:
            _call(cb, "on_train_step_end", step=step, lit=lit, state=state, logger=logger,
                  stride=stride)

    if step < max_steps:
        single = make_train_step(loss_fn, debug_nans=debug_nans)
        while step < max_steps:
            state, _ = _step(holder, single, _place(next(it), device), run_seed)
            step += 1
    return state


def microbatch_generators(generator: torch.Generator, k: int):
    """The k generators of a step's microbatches, each seeded from the step
    generator's seed and the microbatch's index (no draw from it, so no
    device read)."""
    return [step_generator(generator.initial_seed(), j, generator.device) for j in range(k)]


def _microbatched(loss_fn, k: int):
    """Gradient accumulation over k microbatches stacked on a leading axis.
    Each microbatch's gradient is taken on its own and summed, so only one
    microbatch's activations live at a time; the loss and the gradient are
    the means over the k. Returns ``(params, generator, stacked) -> (loss,
    grads)``, marked ``is_grad_fn`` so the train step takes no gradient of
    its own."""

    def accum_grads(params, generator, stacked):
        total, acc = None, None
        for j, g in enumerate(microbatch_generators(generator, k)):
            mb = tuple(b[j] for b in stacked) if isinstance(stacked, tuple) else stacked[j]
            with torch.enable_grad():
                loss = loss_fn(params, g, mb)
                grads = torch.autograd.grad(loss, list(params.values()))
            loss = loss.detach()
            if acc is None:
                total, acc = loss, list(grads)
            else:
                total = total + loss
                torch._foreach_add_(acc, grads)
        torch._foreach_div_(acc, float(k))
        return total / k, dict(zip(params, acc))

    accum_grads.is_grad_fn = True
    return accum_grads


def _call(cb, hook: str, **kwargs) -> None:
    """Call a callback's hook with only the keywords its signature takes."""
    fn = getattr(cb, hook, None)
    if fn is None:
        return
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        fn(**kwargs)
        return
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        fn(**kwargs)
    else:
        fn(**{k: v for k, v in kwargs.items() if k in params})
