"""Evaluation loops (mirrors ``dmme_tpu/training/evaluate.py``).

:func:`validate` is the mean eval-mode diffusion loss over the test split,
no generation. :func:`test` (FID and Inception Score over generated
samples) needs the Inception network and the FID statistics, which are not
ported yet (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dmme_tpu_torch.parallel.train_step import make_eval_step, step_generator
from dmme_tpu_torch.training.checkpoint import CheckpointManager
from dmme_tpu_torch.utils.device import resolve_device


def validate(lit, datamodule, *, ckpt_dir: Optional[str] = None,
             ckpt_step: Optional[int] = None, seed: int = 1337,
             max_batches: Optional[int] = None, use_ema: Optional[bool] = None, state=None,
             device=None) -> Dict[str, float]:
    """The mean eval-mode loss (no dropout, no gradient) over at most
    ``max_batches`` batches of the test split, with the EMA weights unless
    ``use_ema`` (or the harness's ``validate_original_weights``) says
    otherwise. Without ``state``, the latest checkpoint under ``ckpt_dir``
    (or ``ckpt_step``) is restored into a fresh one. Batch i draws its t and
    ε from the generator of (seed, i)."""
    device = resolve_device(device)
    if use_ema is None:
        use_ema = not getattr(lit, "validate_original_weights", False)
    datamodule.prepare_data()
    datamodule.setup("test")
    if state is None:
        state = lit.init_state(torch.Generator().manual_seed(seed), device=device)
        if ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir)
            if ckpt_step is not None or mgr.latest_step() is not None:
                state = mgr.restore(state, step=ckpt_step)
    params = state.ema_params if use_ema else state.params

    def eval_loss(p, generator, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return lit.eval_loss(p, generator, datamodule.process(x))

    step = make_eval_step(eval_loss)
    losses = []
    for i, batch in enumerate(datamodule.test_iter()):
        if max_batches is not None and i >= max_batches:
            break
        x = torch.from_numpy(np.ascontiguousarray(batch[0] if isinstance(batch, tuple)
                                                  else batch)).to(device)
        losses.append(float(step(params, x, step_generator(seed, i, device))))
    return {"val/loss": float(np.mean(losses)) if losses else float("nan"),
            "num_batches": len(losses), "use_ema": use_ema}


def test(*args, **kwargs):
    """FID and Inception Score over generated samples: not ported yet."""
    raise NotImplementedError("test (FID / Inception Score) is not ported yet "
                              "(ROADMAP A.9, evaluation)")
