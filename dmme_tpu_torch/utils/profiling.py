"""Profiling and timing harness (mirrors ``dmme_tpu/utils/profiling.py``).

* :class:`Trace` and :func:`trace` — a ``torch.profiler`` session (host
  operations, and the CUDA device's kernels, copies and memsets where there
  is one) written on stop as a Chrome/TensorBoard trace,
  ``<log_dir>/<pid>.<ns>.pt.trace.json``, where JAX writes an xplane.
* :func:`sync` — wait for the device of a tree's tensors.
* :func:`timed` — wall-clock seconds per call with a device sync, with
  JAX's ``warmup`` and ``iters`` semantics.
* :func:`flops_estimate` — operations counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch


class Trace:
    """One ``torch.profiler`` session into ``log_dir``: :meth:`start`, then
    :meth:`stop`, which writes the trace file and returns its path."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the ``with`` block into ``log_dir``."""
    session = Trace(log_dir)
    session.start()
    try:
        yield session
    finally:
        session.stop()


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def sync(tree: Any) -> None:
    """Wait until everything producing ``tree`` (a tensor, or dicts, lists
    and tuples of them) has run: synchronise the device of its last tensor
    (nothing to wait for on the CPU)."""
    leaves = _leaves(tree)
    if leaves and leaves[-1].device.type == "cuda":
        torch.cuda.synchronize(leaves[-1].device)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call over ``iters`` pipelined calls, after ``warmup``
    calls and a sync."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


def flops_estimate(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": n}``: the floating-point operations of ``fn(*args)``
    (which runs once), as ``FlopCounterMode`` counts them (matmuls,
    convolutions, attention; a multiply-add is two). XLA's cost analysis,
    which the JAX version returns, also reports bytes accessed and
    transcendentals under its own keys; PyTorch has no counterpart of those,
    so this dict holds ``flops`` only."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
