"""Learning-rate schedules (mirrors ``dmme_tpu/training/lr_schedule.py``)."""

from __future__ import annotations

from typing import Callable


def warmup_schedule(lr: float, warmup: int) -> Callable[[int], float]:
    """Linear warmup to ``lr`` over ``warmup`` optimizer steps, then constant:
    lr(count) = lr · min(1, (count + 1)/warmup) on the 0-based step count."""
    if warmup <= 0:
        return lambda count: float(lr)

    def schedule(count: int) -> float:
        return lr * min((count + 1.0) / warmup, 1.0)

    return schedule
