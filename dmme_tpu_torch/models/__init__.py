"""Denoisers as ``nn.Module``s (mirrors ``dmme_tpu.models``): the DDPM and
IDDPM UNets, the ADM family with its noisy classifier (``adm``), and the
Diffusion Transformer (``dit``) with its mixture-of-experts FFN (``moe``)."""

import torch

from dmme_tpu_torch.models import adm, blocks, ddpm, dit, iddpm, moe
from dmme_tpu_torch.models.blocks import init_weights
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.models.unet import UNet, build_topology


def eps_only(model_fn):
    """Adapt a variance-learning denoiser (2C output channels: ε ‖ v, the
    IDDPM convention) to the ε-only contract of the ODE samplers, so that an
    IDDPM-trained model drives DDIM, DPM-Solver++ or UniPC directly."""

    def fn(params, x, t, **kwargs):
        eps, _ = torch.chunk(model_fn(params, x, t, **kwargs), 2, dim=-1)
        return eps

    return fn


__all__ = ["adm", "ddpm", "iddpm", "dit", "moe", "blocks", "UNet", "DiT", "build_topology",
           "init_weights", "eps_only"]
