"""Convolutional KL-VAE, the codec of latent diffusion (mirrors ``dmme_tpu/models/vae.py``).

An (N, H, W, C) image maps to the mean and log-variance of an (N, H/f,
W/f, latent_channels) diagonal-Gaussian posterior, f = 2^(levels − 1), and
a latent decodes back to an image. NHWC at the interface, parameters in
float32. The network calls no fused kernel: its GroupNorms are the plain
``F.group_norm`` (f32 statistics, eps 1e-5, cast to the compute dtype
before the SiLU), as JAX's ``blocks.group_norm`` is a plain
``nn.GroupNorm``. The ``moments`` and ``out`` convolutions run in f32 on
f32 inputs. Module names follow the flax tree (``encoder.down_0_1.conv2``,
``decoder.upsample_1.Conv_0``), so
:func:`~dmme_tpu_torch.utils.convert.from_flax` loads a JAX checkpoint's
parameters unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from dmme_tpu_torch.models.blocks import GroupNorm, Upsample, conv1x1, conv3x3
from dmme_tpu_torch.models.unet import check_param_dtype


class VAEResBlock(nn.Module):
    """GN→SiLU→conv ×2 residual block without timestep conditioning; a 1×1
    ``skip`` projects the input where the channel count changes."""

    def __init__(self, c_in: int, c_out: int, num_groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(num_groups, c_in)
        self.conv1 = conv3x3(c_in, c_out, 1, dtype)
        self.norm2 = GroupNorm(num_groups, c_out)
        self.conv2 = conv3x3(c_out, c_out, 1, dtype)
        self.skip = conv1x1(c_in, c_out, dtype) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x).to(self.dtype)))
        h = self.conv2(F.silu(self.norm2(h).to(self.dtype)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Encoder(nn.Module):
    """Image → (mean, logvar) of the posterior, f32, logvar clipped to [−30, 20]."""

    def __init__(self, in_channels: int, latent_channels: int, base_channels: int,
                 channel_multipliers: Tuple[int, ...], num_res_blocks: int, num_groups: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = conv3x3(in_channels, base_channels, 1, dtype)
        self.levels = []
        c_prev = base_channels
        for i, mult in enumerate(channel_multipliers):
            c = base_channels * mult
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_{j}", VAEResBlock(c_prev, c, num_groups, dtype))
                self.levels.append(f"down_{i}_{j}")
                c_prev = c
            if i < len(channel_multipliers) - 1:  # a stride-2 3x3 conv, padding 1
                self.add_module(f"downsample_{i}", conv3x3(c, c, 2, dtype))
                self.levels.append(f"downsample_{i}")
        self.norm_out = GroupNorm(num_groups, c_prev)
        self.moments = conv3x3(c_prev, 2 * latent_channels, 1, torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.stem(x)
        for name in self.levels:
            h = getattr(self, name)(h)
        h = F.silu(self.norm_out(h).to(self.dtype))
        # the moments in f32: exp(logvar) in bf16 would lose the KL's low bits
        mean, logvar = torch.chunk(self.moments(h.to(torch.float32)), 2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class Decoder(nn.Module):
    """Latent → image, f32."""

    def __init__(self, latent_channels: int, out_channels: int, base_channels: int,
                 channel_multipliers: Tuple[int, ...], num_res_blocks: int, num_groups: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        mults = tuple(channel_multipliers)
        c_prev = base_channels * mults[-1]
        self.stem = conv3x3(latent_channels, c_prev, 1, dtype)
        self.levels = []
        for i in reversed(range(len(mults))):
            c = base_channels * mults[i]
            for j in range(num_res_blocks):
                self.add_module(f"up_{i}_{j}", VAEResBlock(c_prev, c, num_groups, dtype))
                self.levels.append(f"up_{i}_{j}")
                c_prev = c
            if i > 0:
                self.add_module(f"upsample_{i}",
                                Upsample(c, dtype, c_out=base_channels * mults[i - 1]))
                self.levels.append(f"upsample_{i}")
                c_prev = base_channels * mults[i - 1]
        self.norm_out = GroupNorm(num_groups, c_prev)
        self.out = conv3x3(c_prev, out_channels, 1, torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.stem(z)
        for name in self.levels:
            h = getattr(self, name)(h)
        h = F.silu(self.norm_out(h).to(self.dtype))
        return self.out(h.to(torch.float32))


class ConvVAE(nn.Module):
    """KL-regularised convolutional autoencoder (Rombach et al. 2022 §3).

    ``factor = 2^(len(channel_multipliers) − 1)`` is the spatial compression.
    Fully convolutional: one set of weights serves every image size whose
    sides divide by ``factor``. ``encode(x) → (mean, logvar)`` and
    ``decode(z) → image`` are f32; ``forward(x, noise)`` is the
    reparameterised training pass, z = mean + exp(logvar / 2)·noise,
    returning ``(reconstruction, mean, logvar)``. Parameters are float32;
    ``param_dtype`` takes no other value yet.
    """

    def __init__(self, latent_channels: int = 4, base_channels: int = 32,
                 channel_multipliers: Tuple[int, ...] = (1, 2), num_res_blocks: int = 1,
                 out_channels: int = 3, num_groups: int = 8, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        check_param_dtype(param_dtype)
        self.latent_channels = latent_channels
        self.channel_multipliers = tuple(channel_multipliers)
        self.out_channels = out_channels
        self.dtype = dtype
        args = (base_channels, self.channel_multipliers, num_res_blocks, num_groups, dtype)
        self.encoder = Encoder(out_channels, latent_channels, *args)
        self.decoder = Decoder(latent_channels, out_channels, *args)

    @property
    def factor(self) -> int:
        return 2 ** (len(self.channel_multipliers) - 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean, logvar = self.encode(x)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return self.decode(z), mean, logvar


def _part(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def encode(vae: ConvVAE, params: Dict[str, torch.Tensor],
           x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vae.encode(x)`` with ``params`` (a ``state_dict`` of the whole VAE)
    bound, as flax's ``apply(params, x, method=ConvVAE.encode)``."""
    return functional_call(vae.encoder, _part(params, "encoder."), (x,))


def decode(vae: ConvVAE, params: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """``vae.decode(z)`` with ``params`` bound."""
    return functional_call(vae.decoder, _part(params, "decoder."), (z,))


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Mean per-element KL(q(z|x) ‖ N(0, I)) over the batch."""
    return 0.5 * torch.mean(torch.square(mean) + torch.exp(logvar) - 1.0 - logvar)
