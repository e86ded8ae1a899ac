"""Classifier-free guidance (Ho & Salimans 2022; mirrors ``dmme_tpu/diffusion/cfg.py``).

A class-conditional model is trained with label dropout (a share of the
labels replaced by the null token, ``LitDDPM(num_classes=, cond_dropout=)``)
and sampled with the prediction extrapolated past the conditional one:

    ε̂ = ε̂(x, t, ∅) + w · (ε̂(x, t, y) − ε̂(x, t, ∅))

w = 1 is the plain conditional model, w = 0 the unconditional one. The
wrapper has the unconditional denoiser's signature, so every sampler runs
guided unchanged; both branches run as one network call on a doubled batch.
"""

from __future__ import annotations

from typing import Callable

import torch

ModelFn = Callable[..., torch.Tensor]


def classifier_free(model_fn: ModelFn, y, guidance_scale: float, null_label: int) -> ModelFn:
    """Bind labels ``y`` ((N,) integers, or one label for the whole batch)
    and the guidance weight into a model_fn with the unconditional signature.
    ``null_label`` is the unconditional token (the UNet's ``num_classes``).

    For an ε ‖ v output (2·C channels, IDDPM) only the ε half is guided; v
    passes through from the conditional branch, as guided-diffusion does
    (w > 1 on v would push the variance interpolation out of [0, 1])."""
    w = float(guidance_scale)

    def guided(params, x, t, **kwargs):
        n = x.shape[0]
        labels = torch.as_tensor(y, dtype=torch.int64, device=x.device).expand(n)
        t = torch.as_tensor(t, device=x.device).expand(n)
        yy = torch.cat([labels, torch.full((n,), null_label, dtype=torch.int64,
                                           device=x.device)])
        out = model_fn(params, torch.cat([x, x]), torch.cat([t, t]), y=yy, **kwargs)
        cond, uncond = out[:n], out[n:]
        if out.shape[-1] == 2 * x.shape[-1]:  # ε ‖ v: guide ε, keep the conditional v
            c_eps, c_v = torch.chunk(cond, 2, dim=-1)
            u_eps, _ = torch.chunk(uncond, 2, dim=-1)
            return torch.cat([u_eps + w * (c_eps - u_eps), c_v], dim=-1)
        return uncond + w * (cond - uncond)

    return guided
