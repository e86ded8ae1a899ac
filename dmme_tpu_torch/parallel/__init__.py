"""The train step (mirrors ``dmme_tpu.parallel``; one device only so far)."""

from dmme_tpu_torch.parallel.train_step import (
    global_norm,
    make_eval_step,
    make_train_chunk,
    make_train_step,
)

__all__ = ["make_train_step", "make_train_chunk", "make_eval_step", "global_norm"]
