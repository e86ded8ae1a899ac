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
        # a labelled batch (images, labels) conditions a class-conditional
        # model on its true labels; the harness binds any conditioning
        x, y = batch if isinstance(batch, (tuple, list)) else (batch, None)
        return lit.eval_loss(p, generator, datamodule.process(x), y)

    step = make_eval_step(eval_loss)
    losses = []
    for i, batch in enumerate(datamodule.test_iter()):
        if max_batches is not None and i >= max_batches:
            break
        batch = tuple(torch.from_numpy(np.ascontiguousarray(b)).to(device)
                      for b in (batch if isinstance(batch, tuple) else (batch,)))
        losses.append(float(step(params, batch if len(batch) > 1 else batch[0],
                                 step_generator(seed, i, device))))
    return {"val/loss": float(np.mean(losses)) if losses else float("nan"),
            "num_batches": len(losses), "use_ema": use_ema}


def _reject_conditioned_input(lit, where: str) -> None:
    """Raise for a conditioned-input harness (the upsampler: network input
    x_t ‖ cond) on a path that has no conditioning source to give it: the
    server and ``sample --trainer.sampler``."""
    get = getattr(lit, "model_in_channels", None)
    solver_ch = getattr(lit, "latent_channels", getattr(lit, "img_channels", None))
    if get is not None and solver_ch is not None and get() != solver_ch:
        raise ValueError(
            f"{where} has no conditioning source for a conditioned-input "
            f"model ({type(lit).__name__}); sample through "
            "lit.generate(..., low_res=...) — see scripts/upsample_demo.py")


def reject_sampler_override(lit) -> None:
    """Raise for a harness that has no diffusion solver to override (the
    codec's ``LitVAE``, which samples its prior) on a path that names a
    sampler: ``sample --trainer.sampler`` and the server's non-default
    samplers. The message is the JAX package's."""
    if not hasattr(lit, "diffusion_model"):
        raise ValueError(
            "sampler overrides need a diffusion harness; "
            f"{type(lit).__name__} has no solver to override "
            "(a LitVAE samples its prior — drop --trainer.sampler)")


def test(*args, **kwargs):
    """FID and Inception Score over generated samples: not ported yet."""
    raise NotImplementedError("test (FID / Inception Score) is not ported yet "
                              "(ROADMAP A.9, evaluation)")
