"""``fit``: the training loop (mirrors ``dmme_tpu/training/loop.py``).

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
inside a step saves nothing.

On a mesh (``parallel.make_mesh``) every rank runs this loop: the state is
laid out with ``shard_state`` (which also tells the model's MoE layers
where their experts live on an ``expert`` axis, a UNet or a DiT its
tensor group on a ``tensor`` axis, and a UNet its spatial group on a
``spatial`` axis), each rank feeds the slice of the global batch of its
batch index, which a tensor or spatial group shares
(``train_iter(process_index=, process_count=)``), the train step
reduces over the ranks, and at each safe point the ranks vote on stopping
(one small all-reduce), so a signal to one rank stops all of them at the
same step. Rank 0 writes the checkpoints, the metrics and the grids.
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

from dmme_tpu_torch.parallel.distributed import global_batch, world_size
from dmme_tpu_torch.parallel.distributed import place as _place
from dmme_tpu_torch.parallel.mesh import agree
from dmme_tpu_torch.parallel.train_step import (make_train_chunk, make_train_step,
                                                microbatch_generators, shard_state)
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
    ``device="cpu"``. ``mesh``: a ``parallel.make_mesh`` mesh, whose device
    the run takes; every rank of its group calls ``fit``, and a group of
    more than one process needs one.
    """
    if steps_per_call > 1 and accumulate_grad_batches > 1:
        raise ValueError("steps_per_call and accumulate_grad_batches exclude each other")
    if world_size() > 1 and mesh is None:
        raise ValueError(
            "multi-process fit() needs a mesh over the global device list "
            "(e.g. make_mesh()); got mesh=None"
        )
    device = resolve_device(device) if mesh is None else mesh.device
    ranks = 1 if mesh is None else mesh.batch_ranks
    lead = mesh is None or mesh.rank == 0

    datamodule.prepare_data()
    datamodule.setup("fit")
    seq = np.random.SeedSequence(seed)
    init_seed, run_seed = (int(s.generate_state(1, np.uint64)[0] >> 1) for s in seq.spawn(2))
    if state is None:
        state = lit.init_state(torch.Generator().manual_seed(init_seed), device=device)

    ckpt = (CheckpointManager(ckpt_dir, max_to_keep=ckpt_max_to_keep, mesh=mesh)
            if ckpt_dir else None)
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    if mesh is not None and state.mesh is None:
        state = shard_state(state, mesh, model=getattr(lit, "model", None))

    loss_fn = lit.make_loss_fn(datamodule)
    if accumulate_grad_batches > 1:
        loss_fn = _microbatched(loss_fn, accumulate_grad_batches, mesh)
    if steps_per_call > 1:
        train_step = make_train_chunk(loss_fn, steps_per_call, debug_nans=debug_nans, mesh=mesh)
    else:
        train_step = make_train_step(loss_fn, debug_nans=debug_nans, mesh=mesh)

    logger = (MetricLogger(ckpt_dir, tensorboard=tensorboard, loggers=loggers) if lead
              else MetricLogger(loggers=[]))
    for cb in callbacks:
        _call(cb, "on_fit_start", lit=lit, state=state, logger=logger)

    # resume determinism: skip the (global) batches the restored steps consumed
    it_kwargs = {}
    if ranks > 1:
        params = inspect.signature(datamodule.train_iter).parameters
        if "process_index" not in params and not any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
            raise ValueError(
                f"{type(datamodule).__name__}.train_iter does not accept "
                "process_index/process_count — required for multi-process "
                "training (each host must feed its shard of the global "
                "batch; see data/data_module.py)"
            )
        it_kwargs.update(process_index=mesh.batch_index, process_count=ranks)
    it = datamodule.train_iter(seed, skip_batches=state.step * max(accumulate_grad_batches, 1),
                               **it_kwargs)
    if mesh is None:
        place = lambda b, chunked: _place(b, device)  # noqa: E731
    else:
        place = lambda b, chunked: global_batch(  # noqa: E731
            b, mesh, chunked, global_size=getattr(datamodule, "batch_size", None))

    # what an interrupt handler may save: the state, and whether it is whole
    # (False while a step updates it in place)
    holder = {"state": state, "whole": True, "preempted": False, "interrupted": False}
    restore = _install_handlers(holder)
    try:
        try:
            state = _train_loop(lit, holder, max_steps, it, train_step, loss_fn, run_seed,
                                steps_per_call, accumulate_grad_batches, log_every, ckpt,
                                ckpt_every, callbacks, logger, place, debug_nans, mesh)
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


def _stack(batches):
    if isinstance(batches[0], tuple):
        return tuple(np.stack(parts) for parts in zip(*batches))
    return np.stack(batches)


def _step(holder, train_step, batch, run_seed, mesh=None):
    """One train step (or chunk) on the held state, marked torn while it
    runs; then the safe point, where a deferred signal interrupts. On a
    mesh of several ranks they vote first: a signal to any rank stops all."""
    holder["whole"] = False
    state, metrics = train_step(holder["state"], batch, run_seed)
    holder["state"], holder["whole"] = state, True
    if mesh is not None and mesh.world > 1:
        holder["preempted"], holder["interrupted"] = agree(
            mesh, (holder["preempted"], holder["interrupted"]))
    if holder["preempted"] or holder["interrupted"]:
        raise KeyboardInterrupt
    return state, metrics


def _train_loop(lit, holder, max_steps, it, train_step, loss_fn, run_seed, steps_per_call,
                accumulate_grad_batches, log_every, ckpt, ckpt_every, callbacks, logger,
                place, debug_nans, mesh):
    state = holder["state"]
    ranks = 1 if mesh is None else mesh.batch_ranks
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
        batch = place(batch, steps_per_call > 1 or accumulate_grad_batches > 1)
        state, metrics = _step(holder, train_step, batch, run_seed, mesh)
        if steps_per_call > 1:
            metrics = {k: v[-1] for k, v in metrics.items()}
        lead = batch[0] if isinstance(batch, tuple) else batch
        imgs_since += ranks * int(np.prod(lead.shape[:-3]))  # (..., H, W, C) leading dims
        step += stride

        if step % log_every < stride:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the device
            now = time.time()
            m["imgs_per_sec"] = imgs_since / max(now - t_last, 1e-9)
            m["lr"] = lit.lr * min(1.0, step / max(lit.warmup, 1))
            t_last, imgs_since = now, 0
            logger.log(step, m, echo=mesh is None or mesh.rank == 0)
            for cb in callbacks:
                _call(cb, "on_log", step=step, lit=lit, state=state, metrics=m, logger=logger)

        if ckpt is not None and step % ckpt_every < stride:
            ckpt.save(step, state)

        for cb in callbacks:
            _call(cb, "on_train_step_end", step=step, lit=lit, state=state, logger=logger,
                  stride=stride)

    if step < max_steps:
        single = make_train_step(loss_fn, debug_nans=debug_nans, mesh=mesh)
        while step < max_steps:
            state, _ = _step(holder, single, place(next(it), False), run_seed, mesh)
            step += 1
    return state


def _microbatched(loss_fn, k: int, mesh=None):
    """Gradient accumulation over k microbatches stacked on a leading axis.
    Each microbatch's gradient is taken on its own and summed, so only one
    microbatch's activations live at a time; the loss and the gradient are
    the means over the k. Returns ``(params, generator, stacked) -> (loss,
    grads)``, marked ``is_grad_fn`` so the train step takes no gradient of
    its own. On a mesh of R batch ranks, batch rank r's microbatch j draws
    as microbatch j·R + r of one process accumulating k·R."""
    ranks, rank = (1, 0) if mesh is None else (mesh.batch_ranks, mesh.batch_index)

    def accum_grads(params, generator, stacked):
        total, acc = None, None
        for j, g in enumerate(microbatch_generators(generator, k * ranks)[rank::ranks]):
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
