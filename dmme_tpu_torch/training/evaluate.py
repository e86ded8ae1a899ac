"""Evaluation loops (mirrors ``dmme_tpu/training/evaluate.py``).

:func:`validate` is the mean eval-mode diffusion loss over the test split,
no generation. :func:`test` is the reference's test path: per test batch,
FID(real) on the batch's images, a generated batch of the same shape with
the EMA weights, FID(fake) and IS on it; then the FID and
exp(E KL) as the Inception Score (:mod:`dmme_tpu_torch.eval`).
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


def test(lit, datamodule, *, ckpt_dir: Optional[str] = None, ckpt_step: Optional[int] = None,
         seed: int = 1337, max_batches: Optional[int] = None,
         inception_weights: Optional[str] = None, use_ema: Optional[bool] = None, state=None,
         mesh=None, fid_stats: Optional[str] = None, save_fid_stats: Optional[str] = None,
         sampler: Optional[str] = None, sample_steps: Optional[int] = None,
         device=None) -> Dict[str, float]:
    """FID and Inception Score of at most ``max_batches`` generated batches
    against the test split, with the EMA weights unless ``use_ema`` (or
    ``validate_original_weights``) says otherwise. Without ``state``, the
    latest checkpoint under ``ckpt_dir`` (or ``ckpt_step``) is restored into
    a fresh one.

    Batch i generates from the generator of (seed, i): a class-conditional
    model guides on the batch's labels, or on labels drawn from that
    generator first. Generation runs ``lit.diffusion_model``, as the JAX
    package's ``test`` does, not ``lit.generate``: an ``LitIDDPM(sample_steps=)``
    is scored on its full T-step grid, not the strided one it serves.
    ``sampler``/``sample_steps`` replace it with ddim | dpm | unipc | edm |
    flow (:func:`~dmme_tpu_torch.diffusion.factory.make_sampler`; the
    feature-caching samplers are refused there, as in the JAX package).

    ``inception_weights``: a pytorch-fid or torchvision ``.pth``, or the JAX
    package's ``.npz``; without one the Inception is random and the results
    carry a ``warning``. ``fid_stats``: precomputed real (μ, Σ) in
    pytorch-fid's ``.npz``, which skips the real pass; ``save_fid_stats``
    writes this run's. ``device=None`` means the CUDA device."""
    from dmme_tpu_torch.diffusion.factory import make_sampler
    from dmme_tpu_torch.eval import FrechetInceptionDistance, InceptionScore, make_feature_fn
    from dmme_tpu_torch.utils.norm import denorm

    if use_ema is None:
        use_ema = not getattr(lit, "validate_original_weights", False)
    _reject_conditioned_input(lit, "test")
    if not hasattr(lit, "diffusion_model"):
        raise ValueError(
            f"evaluate() scores diffusion harnesses; {type(lit).__name__} "
            "has no sampler. For a LitVAE, FID over prior decodes is not "
            "the codec metric — use `validate` (reconstruction ELBO), or "
            "evaluate the latent-diffusion harness trained on top of it.")
    if sampler is not None:
        algo, adapt = make_sampler(lit.diffusion_model, sampler, sample_steps)
    elif sample_steps is not None:
        raise ValueError("sample_steps without sampler would be silently ignored — "
                         "set sampler (ddim|dpm|unipc|edm) too")
    else:
        algo, adapt = lit.diffusion_model, (lambda fn: fn)
    if mesh is not None:
        raise NotImplementedError(
            "test(mesh=...) is not ported yet (ROADMAP A.11, distribution)")
    device = resolve_device(device)
    datamodule.prepare_data()
    datamodule.setup("test")
    if state is None:
        state = lit.init_state(torch.Generator().manual_seed(seed), device=device)
        if ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir)
            if ckpt_step is not None or mgr.latest_step() is not None:
                state = mgr.restore(state, step=ckpt_step)

    feature_fn = make_feature_fn(inception_weights, device=device)
    fid = FrechetInceptionDistance()
    inception = InceptionScore()  # the class count follows the network
    if fid_stats is not None:
        fid.load_real_stats(fid_stats)
    params = state.ema_params if use_ema else state.params

    n_batches = 0
    for i, batch in enumerate(datamodule.test_iter()):
        if max_batches is not None and i >= max_batches:
            break
        images, labels = batch if isinstance(batch, tuple) else (batch, None)
        real = torch.from_numpy(np.ascontiguousarray(images)).to(device).to(torch.float32) / 255.0
        if fid_stats is None:  # precomputed statistics skip the real pass
            feats, _ = feature_fn(real)
            fid.update(feats, real=True)
        y = None if labels is None else torch.as_tensor(labels, dtype=torch.long, device=device)
        model_fn, generator = lit.sampling_model_fn(step_generator(seed, i, device),
                                                    real.shape[0], y)
        with torch.no_grad():
            fake = algo.generate(adapt(model_fn), params, generator,
                                 lit.sample_space_shape(tuple(real.shape)))
            # a latent harness decodes the solver's output (identity in pixels)
            fake = denorm(lit.to_images(fake))
        feats, logits = feature_fn(fake)
        fid.update(feats, real=False)
        inception.update(logits)
        n_batches += 1

    if save_fid_stats is not None and fid_stats is None:
        fid.save_real_stats(save_fid_stats)
    kl_mean, kl_std = inception.compute()
    results = {
        "fid": fid.compute(),
        "inception_score": float(np.exp(kl_mean)),
        "inception_score_std": kl_std,
        "num_batches": n_batches,
        # FIDs of other solvers or weights are not comparable with each other
        "use_ema": use_ema,
        "sampler": sampler or "default",
        "sample_steps": sample_steps,
    }
    if inception_weights is None:
        results["warning"] = (
            "randomly-initialized InceptionV3 (no weights file provided): "
            "metric values are not comparable to published FID/IS")
    return results
