"""Denoisers as ``nn.Module``s (mirrors ``dmme_tpu.models``): the DDPM and
IDDPM UNets, the ADM family with its noisy classifier (``adm``), the
Diffusion Transformer (``dit``) with its mixture-of-experts FFN (``moe``),
and latent diffusion's KL-VAE codec (``vae``)."""

import torch
from torch.func import functional_call

from dmme_tpu_torch.models import adm, blocks, ddpm, dit, iddpm, moe, vae
from dmme_tpu_torch.models.blocks import init_weights
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.models.unet import UNet, build_topology
from dmme_tpu_torch.models.vae import ConvVAE


def as_model_fn(module: torch.nn.Module):
    """Adapt a module to the diffusion layer's denoiser contract:
    ``model_fn(params, x, t, *, y=None, train=False, generator=None)``, the
    module run with ``params`` (a ``state_dict``-keyed dict) bound through
    ``functional_call`` (``y``: optional class labels for conditional models;
    ``generator``: dropout's draws, where JAX passes ``rngs``)."""

    def model_fn(params, x, t, *, y=None, train=False, generator=None):
        kwargs = {"train": train, "generator": generator}
        if y is not None:
            kwargs["y"] = y
        return functional_call(module, params, (x, t), kwargs)

    return model_fn


def eps_only(model_fn):
    """Adapt a variance-learning denoiser (2C output channels: ε ‖ v, the
    IDDPM convention) to the ε-only contract of the ODE samplers, so that an
    IDDPM-trained model drives DDIM, DPM-Solver++ or UniPC directly."""

    def fn(params, x, t, **kwargs):
        eps, _ = torch.chunk(model_fn(params, x, t, **kwargs), 2, dim=-1)
        return eps

    return fn


__all__ = ["adm", "ddpm", "iddpm", "dit", "moe", "vae", "blocks", "UNet", "DiT", "ConvVAE",
           "build_topology",
           "init_weights", "as_model_fn", "eps_only"]
