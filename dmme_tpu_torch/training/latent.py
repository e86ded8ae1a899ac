"""Latent diffusion: the codec's harness and the latent-space harnesses
(mirrors ``dmme_tpu/training/latent.py``).

The two-stage recipe of Rombach et al. 2022. Stage 1 trains a KL-VAE
(:class:`LitVAE`); stage 2 trains DDPM ε-prediction (:class:`LitLatentDDPM`)
or flow matching (:class:`LitLatentFlow`) in the frozen VAE's latent space,
through :class:`LatentMixin`, which composes onto ``LitDDPM`` and ``LitFlow``.
The denoiser sees ``factor²`` fewer pixels an image. Latents are scaled to
unit variance by ``latent_scale`` (auto-calibrated from the data at fit
time and kept in ``<vae_ckpt>/latent_scale.json``, in the JAX package's
format).

Every surface keeps its pixel-space contract: ``generate`` takes an IMAGE
shape and returns decoded images, and a sampler override
(``sampler="dpm"``, …) integrates its solver in latent space before the
decode. That mapping lives in :meth:`LatentMixin.generate` alone; the
server, the ``sample`` and ``predict`` commands and the ``GenerateImage``
callback pass image shapes to ``generate`` and take its images.

The codec's weights are restored once (a port ``LitVAE`` run directory's EMA
weights, or given), copied once to each device a batch arrives on, and run
under ``no_grad``: no trained parameter lies upstream of the encode, so the
gradient is the same.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models.vae import ConvVAE, decode, encode, kl_divergence
from dmme_tpu_torch.training.checkpoint import CheckpointManager
from dmme_tpu_torch.training.lit import LitDDPM, LitFlow, resolve_dtype
from dmme_tpu_torch.training.lr_schedule import warmup_schedule
from dmme_tpu_torch.training.optimizer import ClipAdam
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.convert import from_flax

#: where the calibrated latent scale is kept, beside the codec's checkpoints
SCALE_FILENAME = "latent_scale.json"


def _latent_side(side: int, factor: int) -> int:
    """The encoder's output side: each stride-2 conv (padding 1) takes ⌈s/2⌉."""
    while factor > 1:
        side, factor = (side + 1) // 2, factor // 2
    return side


class LitVAE:
    """KL-VAE training harness (stage 1 of latent diffusion), on the same
    protocol as the diffusion harnesses (``init_state`` / ``make_loss_fn`` /
    ``eval_loss`` / ``generate``), so ``fit``, checkpoints, callbacks and the
    command line drive it unchanged. Objective: pixel MSE +
    ``kl_weight``·KL(q ‖ N(0, I)); the optimizer is the global-norm clip and
    Adam at the warmup schedule, without weight decay."""

    def __init__(
        self,
        lr: float = 1e-4,
        warmup: int = 500,
        decay: float = 0.999,
        model: Optional[ConvVAE] = None,
        kl_weight: float = 1e-4,
        grad_clip: float = 1.0,
        img_channels: int = 3,
        dtype: Union[str, torch.dtype] = torch.float32,
        ema_every_n_steps: int = 1,
        validate_original_weights: bool = False,
    ) -> None:
        self.lr = lr
        self.warmup = warmup
        self.decay = decay
        self.kl_weight = kl_weight
        self.grad_clip = grad_clip
        self.img_channels = img_channels
        self.ema_every_n_steps = ema_every_n_steps
        self.validate_original_weights = validate_original_weights
        self.num_classes = None  # unconditional
        if model is None:
            model = ConvVAE(out_channels=img_channels, dtype=resolve_dtype(dtype))
        self.model = model

    def make_optimizer(self) -> ClipAdam:
        return ClipAdam(self.grad_clip, warmup_schedule(self.lr, self.warmup))

    #: fresh weights with flax's default init, the optimizer and the EMA, as
    #: the diffusion harnesses make them
    init_state = LitDDPM.init_state

    def latent_shape(self, img_shape: Tuple[int, ...]) -> Tuple[int, int, int, int]:
        n, h, w = img_shape[:3]
        f = self.model.factor
        return (n, _latent_side(h, f), _latent_side(w, f), self.model.latent_channels)

    def make_loss_fn(self, datamodule=None):
        """``loss_fn(params, generator, batch)`` over raw batches: the
        datamodule's augment → process, then :meth:`loss_given` on the
        posterior noise, drawn from ``generator`` after the flip."""

        def loss_fn(params, generator, batch):
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if datamodule is not None:
                x = datamodule.train_transform(generator, x)
            noise = torch.randn(self.latent_shape(x.shape), generator=generator,
                                dtype=torch.float32, device=generator.device)
            return self.loss_given(params, x, noise)

        return loss_fn

    def loss_given(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
        """The training objective on the posterior sample mean + σ·``noise``:
        the deterministic core of the loss."""
        recon, mean, logvar = functional_call(self.model, params, (x, noise.to(x.device)))
        return self._objective(recon, x, mean, logvar)

    def _objective(self, recon, x, mean, logvar) -> torch.Tensor:
        recon_loss = torch.mean(torch.square(recon - x.to(torch.float32)))
        return recon_loss + self.kl_weight * kl_divergence(mean, logvar)

    @torch.no_grad()
    def eval_loss(self, params, generator: torch.Generator, x: torch.Tensor,
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The objective with the posterior MEAN decoded: deterministic."""
        mean, logvar = encode(self.model, params, x)
        return self._objective(decode(self.model, params, mean), x, mean, logvar)

    def _params(self, state: TrainState, use_ema: Optional[bool]):
        if use_ema is None:
            use_ema = not self.validate_original_weights
        return state.ema_params if use_ema else state.params

    @torch.no_grad()
    def generate(self, state: TrainState, generator: torch.Generator,
                 img_shape: Tuple[int, ...], *, use_ema: Optional[bool] = None,
                 history_length: Optional[int] = None, y: Optional[torch.Tensor] = None):
        """Decoded prior samples z ~ N(0, I) at ``img_shape``: a codec health
        check for the GenerateImage and sample surfaces (the latent diffusion
        model is the generator). With ``history_length`` the history is the
        sample repeated, as there is no trajectory. There is no solver to
        override (the surfaces refuse a sampler name:
        :func:`~dmme_tpu_torch.training.evaluate.reject_sampler_override`)."""
        params = self._params(state, use_ema)
        device = next(iter(params.values())).device
        z = torch.randn(self.latent_shape(img_shape), generator=generator, dtype=torch.float32,
                        device=generator.device)
        out = decode(self.model, params, z.to(device))
        if history_length is not None:
            reps = max(int(history_length), 1)
            return out, out[None].expand((reps,) + tuple(out.shape))
        return out

    @torch.no_grad()
    def reconstruct(self, state: TrainState, x: torch.Tensor, *,
                    use_ema: bool = True) -> torch.Tensor:
        """decode(E[z|x]): the deterministic round trip."""
        params = state.ema_params if use_ema else state.params
        mean, _ = encode(self.model, params, x)
        return decode(self.model, params, mean)


class LatentMixin:
    """Moves ``LitDDPM`` or ``LitFlow`` into a frozen VAE's latent space.

    It overrides the seam of ``training/lit.py``: ``encode_target`` (the
    training target: the scaled posterior sample, its noise drawn after the
    flip and before the label drop), ``encode_eval`` (the scaled posterior
    mean), ``sample_space_shape``, ``to_images`` (decode of z / scale),
    ``model_in_channels`` and ``generate`` (image shape in, images out).

    ``vae_params`` is the codec's ``state_dict`` (or a flax params tree); or
    ``vae_ckpt`` names a port ``LitVAE`` run directory, whose latest
    checkpoint's EMA weights are read once. ``latent_scale=None`` takes
    ``<vae_ckpt>/latent_scale.json``, or else calibrates 1/std of the
    posterior means of the first ``scale_probe_n`` training images at fit
    time and writes it there. Without ``model`` the denoiser is the DDPM
    UNet at latent width with both kernel switches on, as ``LitDDPM``'s
    default."""

    def __init__(
        self,
        *args,
        vae: Optional[ConvVAE] = None,
        vae_ckpt: Optional[str] = None,
        vae_params: Any = None,
        latent_scale: Optional[float] = None,
        scale_probe_n: int = 256,
        **kwargs,
    ) -> None:
        if vae is None:
            vae = ConvVAE()
        self.vae = vae
        self.vae_ckpt = vae_ckpt
        self.latent_channels = vae.latent_channels
        self._scale = float(latent_scale) if latent_scale else None
        self.scale_probe_n = scale_probe_n
        self._codec: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._device: Optional[torch.device] = None
        if kwargs.get("model") is None:
            kwargs["model"] = ddpm_models.UNet(
                in_channels=vae.latent_channels,
                dtype=resolve_dtype(kwargs.get("dtype", torch.float32)),
                fused_norm=True, fused_block=True, num_classes=kwargs.get("num_classes"))
        super().__init__(*args, **kwargs)

        if vae_params is None:
            if vae_ckpt is None:
                raise ValueError("latent harness needs the stage-1 codec: pass vae_ckpt "
                                 "(a LitVAE run directory) or vae_params")
            if not os.path.isdir(vae_ckpt) or CheckpointManager(vae_ckpt).latest_step() is None:
                raise ValueError(
                    f"no stage-1 VAE checkpoint under {vae_ckpt!r} — train the codec first "
                    "(e.g. `python -m dmme_tpu_torch.trainer fit --config "
                    "configs/latent/shapes_vae_demo.yaml`), or pass vae_params directly")
            vae_params = CheckpointManager(vae_ckpt).load()["ema_params"]
        elif any(isinstance(v, Mapping) for v in vae_params.values()):
            vae_params = from_flax(vae_params)
        vae.load_state_dict(vae_params, strict=True)  # every key, every shape
        self.vae_params = {k: v.detach().to(torch.float32) for k, v in vae_params.items()}

    # ------------------------------------------------------------ the hooks
    def init_state(self, generator: Union[int, torch.Generator] = 0,
                   device: Union[None, str, torch.device] = None) -> TrainState:
        state = super().init_state(generator, device)
        self._device = next(iter(state.params.values())).device  # where the scale probe runs
        return state

    def model_in_channels(self) -> int:
        return self.latent_channels

    def _codec_params(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The codec's weights on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._codec:
            self._codec[device] = {k: v.to(device) for k, v in self.vae_params.items()}
        return self._codec[device]

    def encode_target(self, generator: torch.Generator, x: torch.Tensor,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels → scale · (mean + σ·ε), ε drawn from ``generator`` unless
        given as ``noise``."""
        scale = self._require_scale()
        with torch.no_grad():
            mean, logvar = encode(self.vae, self._codec_params(x.device), x)
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                    device=generator.device)
            return (mean + torch.exp(0.5 * logvar) * noise.to(mean.device)) * scale

    def encode_eval(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            mean, _ = encode(self.vae, self._codec_params(x.device), x)
        return mean * self._require_scale()

    def sample_space_shape(self, img_shape):
        n, h, w, _ = img_shape
        f = self.vae.factor
        if h % f or w % f:
            raise ValueError(f"image side {h}x{w} not divisible by factor {f}")
        return (n, h // f, w // f, self.latent_channels)

    @torch.no_grad()
    def to_images(self, out: torch.Tensor) -> torch.Tensor:
        """Decode of out / scale; a (T, N, h, w, c) history frame by frame."""
        scale = self._require_scale()
        params = self._codec_params(out.device)
        if out.dim() == 5:
            return torch.stack([decode(self.vae, params, frame / scale) for frame in out])
        return decode(self.vae, params, out / scale)

    def generate(self, state: TrainState, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, history_length: Optional[int] = None,
                 **kwargs: Any):
        """The base harness's ``generate`` (every keyword: ``sampler``,
        ``steps``, ``x_T`` in latent space, …) at the latent shape of the
        IMAGE shape ``img_shape``, decoded: images, or (images, decoded
        history) with ``history_length``."""
        out = super().generate(state, generator, self.sample_space_shape(img_shape),
                               history_length=history_length, **kwargs)
        if history_length is not None:
            final, hist = out
            return self.to_images(final), self.to_images(hist)
        return self.to_images(out)

    # ------------------------------------------------------------ the scale
    def make_loss_fn(self, datamodule=None):
        self._resolve_scale(datamodule)  # and persist it, before the first step
        return super().make_loss_fn(datamodule)

    def _scale_path(self) -> Optional[str]:
        return None if self.vae_ckpt is None else os.path.join(self.vae_ckpt, SCALE_FILENAME)

    def _require_scale(self) -> float:
        if self._scale is None:
            self._resolve_scale(None)
        return self._scale

    def _resolve_scale(self, datamodule) -> float:
        """An explicit value, else the persisted JSON, else 1/std (population)
        of the posterior means of the first ``scale_probe_n`` processed
        training images, no augmentation, written to the JSON."""
        if self._scale is not None:
            return self._scale
        path = self._scale_path()
        if path is not None and os.path.exists(path):
            with open(path) as f:
                self._scale = float(json.load(f)["latent_scale"])
            return self._scale
        if datamodule is None:
            raise ValueError(
                f"latent_scale unresolved: no explicit value, no {SCALE_FILENAME} next to the "
                "VAE checkpoint, and no datamodule to calibrate from — fit first, or set "
                "model.init_args.latent_scale")
        datamodule.setup("fit")
        n = int(min(self.scale_probe_n, len(datamodule.train_data)))
        device = self._device or torch.device("cpu")
        x = datamodule.process(torch.from_numpy(datamodule.train_data[:n]).to(device))
        with torch.no_grad():
            mean, _ = encode(self.vae, self._codec_params(device), x)
        std = float(torch.std(mean.to(torch.float64), correction=0))
        self._scale = 1.0 / max(std, 1e-6)
        if path is not None:
            os.makedirs(self.vae_ckpt, exist_ok=True)
            with open(path, "w") as f:
                json.dump({"latent_scale": self._scale, "probe_n": n}, f)
        return self._scale


class LitLatentDDPM(LatentMixin, LitDDPM):
    """Latent-space DDPM: ε-prediction on scaled VAE latents. Every sampler
    override runs in latent space and decodes through ``to_images``."""


class LitLatentFlow(LatentMixin, LitFlow):
    """Latent flow matching; with a DiT denoiser, the SD3 recipe (latent
    space × rectified flow × transformer)."""
