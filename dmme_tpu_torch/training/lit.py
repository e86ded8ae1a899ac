"""``LitDDPM`` / ``LitDDIM``: the training and sampling harnesses of ``dmme_tpu/training/lit.py``.

The harness owns the denoiser module, the diffusion algorithm and the
optimizer recipe; the weights live apart from the module in a
:class:`~dmme_tpu_torch.training.state.TrainState` (raw and EMA
``state_dict``s, Adam's moments), and every model call binds them with
``torch.func.functional_call``, as the JAX package applies its params tree.
The default denoiser is the DDPM UNet with the fused GroupNorm+SiLU and
fused ResBlock kernels switched on; training ignores the fused ResBlock
(it has no backward), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from dmme_tpu_torch.diffusion import DDIM, DDPM
from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.training.lr_schedule import warmup_schedule
from dmme_tpu_torch.training.optimizer import ClipAdam
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.device import resolve_device

#: dtype names the configs use, with the JAX package's aliases (``dmme_tpu/config.py``)
_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
           "fp16": torch.float16, "float16": torch.float16}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype name (``bf16``, ``fp32``/``f32``, ``fp16`` or the full names)
    or a torch dtype → the torch dtype. On the card bf16 runs the tensor-core
    kernels, f32 and fp16 their ``simt.cu`` versions
    (:func:`dmme_tpu_torch.ops.route`)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of {sorted(_DTYPES)}") from None


class LitDDPM:
    """DDPM harness: the optimizer recipe, the training loss and sampling."""

    def __init__(
        self,
        lr: float = 2e-4,
        warmup: int = 5000,
        decay: float = 0.9999,
        diffusion_model: Optional[DDPM] = None,
        model: Optional[torch.nn.Module] = None,
        timesteps: int = 1000,
        grad_clip: float = 1.0,
        img_channels: int = 3,
        dtype: Union[str, torch.dtype] = torch.float32,
        ema_every_n_steps: int = 1,
        validate_original_weights: bool = False,
        parameterization: str = "eps",
        snr_gamma: Optional[float] = None,
    ) -> None:
        self.lr = lr
        self.warmup = warmup
        self.decay = decay
        self.grad_clip = grad_clip
        self.img_channels = img_channels
        self.ema_every_n_steps = ema_every_n_steps
        self.validate_original_weights = validate_original_weights
        if model is None:
            model = ddpm_models.UNet(in_channels=img_channels, dtype=resolve_dtype(dtype),
                                     fused_norm=True, fused_block=True)
        self.model = model
        if diffusion_model is None:
            diffusion_model = DDPM.create(timesteps, parameterization=parameterization,
                                          snr_gamma=snr_gamma)
        self.diffusion_model = diffusion_model

    def make_optimizer(self) -> ClipAdam:
        """Global-norm clip at ``grad_clip``, then Adam at the warmup schedule."""
        return ClipAdam(self.grad_clip, warmup_schedule(self.lr, self.warmup))

    def init_state(self, generator: Union[int, torch.Generator] = 0,
                   device: Union[None, str, torch.device] = None) -> TrainState:
        """Fresh weights with flax's default init, drawn on the CPU from
        ``generator`` (or a seed), and the optimizer state, on ``device``
        (None: the CUDA device; raises without one)."""
        device = resolve_device(device)
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        init_weights(self.model, generator)
        params = {k: v.detach().clone().to(device) for k, v in self.model.state_dict().items()}
        return TrainState.create(params, self.make_optimizer(), ema_decay=self.decay,
                                 ema_every_n_steps=self.ema_every_n_steps)

    def model_fn(self, params: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                 **kwargs) -> torch.Tensor:
        """The denoiser with ``params`` bound: ``model(x, t, **kwargs)``."""
        return functional_call(self.model, params, (x, t), kwargs)

    def make_loss_fn(self, datamodule=None):
        """``loss_fn(params, generator, batch)`` over raw uint8 batches: the
        datamodule's augment → process, then the diffusion loss with dropout.
        Every draw (flip, t, ε, dropout) comes from ``generator``, in that
        order. A labelled batch ``(images, labels)`` trains on the images."""

        def loss_fn(params, generator, batch):
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if datamodule is not None:
                x = datamodule.train_transform(generator, x)
            return self.diffusion_model.loss(self.model_fn, params, generator, x, train=True)

        return loss_fn

    @torch.no_grad()
    def eval_loss(self, params, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode diffusion loss on a processed batch: no dropout, no
        gradient (so the UNet may take the fused ResBlock kernel)."""
        return self.diffusion_model.loss(self.model_fn, params, generator, x, train=False)

    def sampling_model_fn(self, generator, n: int):
        """(model_fn, generator) for sampling; unconditional models pass through."""
        return self.model_fn, generator

    def sample_space_shape(self, img_shape):
        """Image shape → the shape the diffusion solver integrates."""
        return img_shape

    def to_images(self, out):
        """Solver output → images."""
        return out

    def generate(self, state: TrainState, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, use_ema: Optional[bool] = None,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """Sample with the EMA weights unless ``validate_original_weights``
        (or ``use_ema=False``) asks for the raw ones. With ``history_length``,
        returns ``(x_0, history)`` (see ``DDPM.generate``)."""
        if use_ema is None:
            use_ema = not self.validate_original_weights
        params = state.ema_params if use_ema else state.params
        model_fn, generator = self.sampling_model_fn(generator, img_shape[0])
        return self.diffusion_model.generate(model_fn, params, generator, img_shape, x_T=x_T,
                                             history_length=history_length)


class LitDDIM(LitDDPM):
    """DDIM harness: the strided sampler over the same model and training."""

    def __init__(
        self,
        lr: float = 2e-4,
        warmup: int = 5000,
        decay: float = 0.9999,
        diffusion_model: Optional[DDIM] = None,
        model: Optional[torch.nn.Module] = None,
        timesteps: int = 1000,
        sample_steps: int = 50,
        tau_schedule: str = "quadratic",
        variant: str = "canonical",
        parameterization: str = "eps",
        snr_gamma: Optional[float] = None,
        **kwargs: Any,
    ):
        if diffusion_model is None:
            diffusion_model = DDIM.create(timesteps, sample_steps, tau_schedule,
                                          variant=variant, parameterization=parameterization,
                                          snr_gamma=snr_gamma)
        super().__init__(lr, warmup, decay, diffusion_model, model, timesteps, **kwargs)
