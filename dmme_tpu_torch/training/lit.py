"""``LitDDPM`` / ``LitDDIM``: the sampling surface of ``dmme_tpu/training/lit.py``.

The harness owns the denoiser module and the diffusion algorithm; the
weights live apart from the module in a :class:`ParamsState` (raw and EMA
``state_dict``s), and every model call binds them with
``torch.func.functional_call``, as the JAX package applies its params tree.
The default denoiser is the DDPM UNet with the fused GroupNorm+SiLU and
fused ResBlock kernels switched on. Training (optimizer, EMA updates, the
loss) is not part of this module yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from dmme_tpu_torch.diffusion import DDIM, DDPM
from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models import init_weights

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"bf16"``/``"f32"`` (or a torch dtype) → the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass
class ParamsState:
    """The weights a sampler needs: step count, raw and EMA ``state_dict``s."""

    step: int
    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor]) -> "ParamsState":
        """Step 0, with the EMA copy equal to the raw weights."""
        return cls(0, dict(params), {k: v.clone() for k, v in params.items()})

    def to(self, device) -> "ParamsState":
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return ParamsState(self.step, move(self.params), move(self.ema_params))


class LitDDPM:
    """DDPM harness, sampling surface."""

    def __init__(
        self,
        diffusion_model: Optional[DDPM] = None,
        model: Optional[torch.nn.Module] = None,
        timesteps: int = 1000,
        img_channels: int = 3,
        dtype: Union[str, torch.dtype] = torch.float32,
        validate_original_weights: bool = False,
        parameterization: str = "eps",
    ) -> None:
        self.img_channels = img_channels
        self.validate_original_weights = validate_original_weights
        if model is None:
            model = ddpm_models.UNet(in_channels=img_channels, dtype=resolve_dtype(dtype),
                                     fused_norm=True, fused_block=True)
        self.model = model
        if diffusion_model is None:
            diffusion_model = DDPM.create(timesteps, parameterization=parameterization)
        self.diffusion_model = diffusion_model

    def init_state(self, generator: Union[int, torch.Generator] = 0) -> ParamsState:
        """Fresh weights with flax's default init, drawn on the CPU from
        ``generator`` (or a seed)."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        init_weights(self.model, generator)
        return ParamsState.create(
            {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        )

    def model_fn(self, params: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                 **kwargs) -> torch.Tensor:
        """The denoiser with ``params`` bound: ``model(x, t, **kwargs)``."""
        return functional_call(self.model, params, (x, t), kwargs)

    def sampling_model_fn(self, generator, n: int):
        """(model_fn, generator) for sampling; unconditional models pass through."""
        return self.model_fn, generator

    def sample_space_shape(self, img_shape):
        """Image shape → the shape the diffusion solver integrates."""
        return img_shape

    def to_images(self, out):
        """Solver output → images."""
        return out

    def generate(self, state: ParamsState, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, use_ema: Optional[bool] = None,
                 x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample with the EMA weights unless ``validate_original_weights``
        (or ``use_ema=False``) asks for the raw ones."""
        if use_ema is None:
            use_ema = not self.validate_original_weights
        params = state.ema_params if use_ema else state.params
        model_fn, generator = self.sampling_model_fn(generator, img_shape[0])
        return self.diffusion_model.generate(model_fn, params, generator, img_shape, x_T=x_T)


class LitDDIM(LitDDPM):
    """DDIM harness: the strided sampler over the same model."""

    def __init__(
        self,
        diffusion_model: Optional[DDIM] = None,
        model: Optional[torch.nn.Module] = None,
        timesteps: int = 1000,
        sample_steps: int = 50,
        tau_schedule: str = "quadratic",
        variant: str = "canonical",
        parameterization: str = "eps",
        **kwargs: Any,
    ):
        if diffusion_model is None:
            diffusion_model = DDIM.create(timesteps, sample_steps, tau_schedule,
                                          variant=variant, parameterization=parameterization)
        super().__init__(diffusion_model, model, timesteps,
                         parameterization=parameterization, **kwargs)
