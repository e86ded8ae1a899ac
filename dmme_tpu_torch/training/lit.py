"""``LitDDPM`` / ``LitDDIM`` / ``LitIDDPM`` / ``LitEDM`` / ``LitFlow`` /
``LitUpsampler`` / ``LitDistill``: the training and sampling harnesses of
``dmme_tpu/training/lit.py``.

The harness owns the denoiser module, the diffusion algorithm and the
optimizer recipe; the weights live apart from the module in a
:class:`~dmme_tpu_torch.training.state.TrainState` (raw and EMA
``state_dict``s, Adam's moments), and every model call binds them with
``torch.func.functional_call``, as the JAX package applies its params tree.
The default denoiser is the DDPM UNet with the fused GroupNorm+SiLU and
fused ResBlock kernels switched on; training ignores the fused ResBlock
(it has no backward), as in JAX.

With ``num_classes`` a harness trains a class-conditional model with label
dropout to the null token and samples it through classifier-free guidance
(:func:`~dmme_tpu_torch.diffusion.cfg.classifier_free`); the labels reach
the network only through a bound model_fn, so the diffusion algorithms stay
label-agnostic. With ``moe_aux_weight > 0`` every harness's training loss
adds the router losses a mixture-of-experts DiT records, through the shared
:meth:`LitDDPM.loss_model_fn` and :meth:`LitDDPM.add_moe_aux`, as JAX's do;
evaluation adds none.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dmme_tpu_torch.diffusion import (DDIM, DDPM, EDM, IDDPM, FlowMatching, classifier_free,
                                      make_sampler)
from dmme_tpu_torch.diffusion.factory import MODULE_SAMPLERS, make_module_sampler
from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models import iddpm as iddpm_models
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
    or a torch dtype → the torch dtype. On the card K3 and K4 run on the
    tensor cores in every dtype (f32 as 3xTF32), K1 and K2 on them in bf16
    and on the CUDA cores (``simt.cu``) in f32 and fp16
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
        num_classes: Optional[int] = None,
        cond_dropout: float = 0.1,
        parameterization: str = "eps",
        snr_gamma: Optional[float] = None,
        guidance_scale: float = 1.0,
        moe_aux_weight: float = 0.0,
        moe_z_weight: float = 1e-3,
    ) -> None:
        self.lr = lr
        self.warmup = warmup
        self.decay = decay
        self.grad_clip = grad_clip
        self.img_channels = img_channels
        self.ema_every_n_steps = ema_every_n_steps
        self.validate_original_weights = validate_original_weights
        #: a class-conditional model, trained with ``cond_dropout`` of the
        #: labels replaced by the null token ``num_classes`` and sampled
        #: through classifier-free guidance at ``guidance_scale`` (1.0: the
        #: plain conditional model)
        self.num_classes = num_classes
        self.cond_dropout = cond_dropout
        self.guidance_scale = guidance_scale
        #: > 0: add the router losses of a mixture-of-experts model (a DiT
        #: with ``num_experts``) to the training loss, the Switch load-balance
        #: and alignment losses at ``moe_aux_weight`` and the raw router
        #: z-loss at ``moe_z_weight`` (:meth:`loss_model_fn`, :meth:`add_moe_aux`)
        self.moe_aux_weight = moe_aux_weight
        self.moe_z_weight = moe_z_weight
        if model is None:
            model = ddpm_models.UNet(in_channels=img_channels, dtype=resolve_dtype(dtype),
                                     fused_norm=True, fused_block=True, num_classes=num_classes)
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

    def model_in_channels(self) -> int:
        """Channels of the network's input (a conditioned-input harness, the
        upsampler's x_t ‖ cond, takes more than ``img_channels``)."""
        return self.img_channels

    def labelled_model_fn(self, y: torch.Tensor):
        """``model_fn`` with the (N,) labels ``y`` bound."""

        def model_fn(params, x, t, **kwargs):
            return self.model_fn(params, x, t, y=y, **kwargs)

        return model_fn

    def drop_labels(self, generator: torch.Generator, y: torch.Tensor) -> torch.Tensor:
        """``y`` with each label replaced by the null token ``num_classes``
        with probability ``cond_dropout``, drawn from ``generator``."""
        drop = torch.rand(y.shape, generator=generator, device=generator.device) < self.cond_dropout
        return torch.where(drop.to(y.device), self.num_classes, y)

    def make_loss_fn(self, datamodule=None):
        """``loss_fn(params, generator, batch)`` over raw uint8 batches: the
        datamodule's augment → process, then the diffusion loss with dropout.
        A labelled batch ``(images, labels)`` trains a class-conditional model
        on its labels, ``cond_dropout`` of them dropped to the null token
        (an unconditional model trains on the images). Every draw comes from
        ``generator``, in the order of the JAX package's key splits: flip,
        drop mask, then the algorithm's (t, ε) and the model's dropout; a
        latent harness draws its posterior sample between flip and drop mask
        (:meth:`encode_target`)."""

        def loss_fn(params, generator, batch):
            x, y = batch if isinstance(batch, (tuple, list)) else (batch, None)
            if datamodule is not None:
                x = datamodule.train_transform(generator, x)
            # the latent seam (training/latent.py): the identity here, drawing nothing
            x = self.encode_target(generator, x)
            box: list = []
            model_fn = base_fn = self.loss_model_fn(box)
            if y is not None and self.num_classes is not None:
                y_used = self.drop_labels(generator, y)

                def model_fn(params, x_t, t, **kwargs):
                    return base_fn(params, x_t, t, y=y_used, **kwargs)

            loss = self.diffusion_model.loss(model_fn, params, generator, x, train=True)
            return self.add_moe_aux(loss, box)

        return loss_fn

    def loss_model_fn(self, box: list):
        """The model_fn of a training loss. With ``moe_aux_weight > 0`` and a
        model that records router losses (a ``moe_losses`` keyword), each
        call appends (Σ moe_aux + moe_align, Σ moe_z) over its MoE blocks to
        ``box``; otherwise it is :meth:`model_fn`. Every harness's loss goes
        through it, and :meth:`add_moe_aux` closes the loss."""
        if self.moe_aux_weight <= 0 or not records_router_losses(self.model):
            return self.model_fn

        def model_fn(params, x, t, **kwargs):
            stats: list = []
            out = self.model_fn(params, x, t, moe_losses=stats, **kwargs)
            if stats:
                box.append((sum(s["moe_aux"] + s.get("moe_align", 0.0) for s in stats),
                            sum(s["moe_z"] for s in stats)))
            return out

        return model_fn

    def add_moe_aux(self, loss: torch.Tensor, box: list) -> torch.Tensor:
        """loss + moe_aux_weight·Σ aux + moe_z_weight·Σ z over what
        :meth:`loss_model_fn` collected; the loss itself where nothing was."""
        if not box:
            return loss
        aux = sum(a for a, _ in box)
        z = sum(z_ for _, z_ in box)
        return loss + self.moe_aux_weight * aux + self.moe_z_weight * z

    @torch.no_grad()
    def eval_loss(self, params, generator: torch.Generator, x: torch.Tensor,
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eval-mode diffusion loss on a processed batch: no dropout, no
        gradient (so the UNet may take the fused ResBlock kernel). A
        class-conditional model conditions on the true labels ``y``."""
        x = self.encode_eval(x)
        model_fn = self.model_fn
        if y is not None and self.num_classes is not None:
            model_fn = self.labelled_model_fn(y)
        return self.diffusion_model.loss(model_fn, params, generator, x, train=False)

    def sampling_model_fn(self, generator: Optional[torch.Generator], n: int,
                          y: Optional[torch.Tensor] = None):
        """(model_fn, generator) for sampling: unconditional models pass
        through; class-conditional ones get the classifier-free wrapper at
        ``guidance_scale`` on the labels ``y``, or on ``n`` labels drawn
        uniformly from ``generator`` where ``y`` is None."""
        if self.num_classes is None:
            return self.model_fn, generator
        if y is None:
            if generator is None:
                raise ValueError("sampling a class-conditional model needs labels y or a "
                                 "generator to draw them from")
            y = torch.randint(0, self.num_classes, (n,), generator=generator,
                              device=generator.device)
        return classifier_free(self.model_fn, y, self.guidance_scale, self.num_classes), generator

    # the latent-space seam: the identity here; training/latent.py's
    # LatentMixin overrides these hooks to train and sample in a frozen
    # VAE's latent space, and maps image shapes in its own generate
    def encode_target(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """The training target of a processed batch. Draws nothing here (every
        pixel harness's draw order is pinned by tests)."""
        return x

    def encode_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The evaluation target of a processed batch."""
        return x

    def sample_space_shape(self, img_shape):
        """Image shape → the shape the diffusion solver integrates."""
        return img_shape

    def to_images(self, out):
        """Solver output → images."""
        return out

    def generate(self, state: TrainState, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, use_ema: Optional[bool] = None,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None,
                 sampler: Optional[str] = None, steps: Optional[int] = None,
                 refresh_interval: int = 2, cache_depth: int = 1,
                 y: Optional[torch.Tensor] = None):
        """Sample with the EMA weights unless ``validate_original_weights``
        (or ``use_ema=False``) asks for the raw ones. With ``history_length``,
        returns ``(x_0, history)`` (see ``DDPM.generate``). A class-conditional
        model samples through classifier-free guidance on the labels ``y``,
        drawn uniformly where None (:meth:`sampling_model_fn`). ``sampler``
        replaces the harness's own sampler: ddim | dpm | unipc | edm | flow
        with that solver in ``steps`` steps on the trained schedule or
        hyperparameters (:func:`~dmme_tpu_torch.diffusion.factory.make_sampler`),
        cached | deep | deep_dpm with the feature-caching sampler on the UNet
        module, refreshed every ``refresh_interval`` steps (``cache_depth``:
        the deep core's boundary; :func:`~dmme_tpu_torch.diffusion.factory.
        make_module_sampler`)."""
        if use_ema is None:
            use_ema = not self.validate_original_weights
        params = state.ema_params if use_ema else state.params
        if sampler in MODULE_SAMPLERS:
            algo = make_module_sampler(self.diffusion_model, sampler, steps,
                                       refresh_interval=refresh_interval,
                                       cache_depth=cache_depth,
                                       conditional=self.num_classes is not None)
            return algo.generate(self.model, params, generator, img_shape, x_T=x_T,
                                 history_length=history_length)
        model_fn, generator = self.sampling_model_fn(generator, img_shape[0], y)
        algo = self.sample_algorithm()
        if sampler is not None:
            algo, adapt = make_sampler(self.diffusion_model, sampler, steps)
            model_fn = adapt(model_fn)
        return algo.generate(model_fn, params, generator, img_shape, x_T=x_T,
                             history_length=history_length)

    def sample_algorithm(self):
        """The algorithm :meth:`generate` samples with."""
        return self.diffusion_model


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


class LitIDDPM(LitDDPM):
    """IDDPM harness: the variance-learning UNet and the hybrid loss. With
    ``sample_steps``, :meth:`generate` samples on the ``sample_steps``-step
    respaced grid with the learned variances (``IDDPM.strided``); the other
    keyword arguments are :class:`LitDDPM`'s."""

    def __init__(
        self,
        lr: float = 1e-4,
        warmup: int = 5000,
        decay: float = 0.9999,
        diffusion_model: Optional[IDDPM] = None,
        model: Optional[torch.nn.Module] = None,
        timesteps: int = 1000,
        loss_type: str = "hybrid",
        gamma: float = 0.001,
        schedule: str = "cosine",
        offset: float = 0.008,
        start: float = 0.0001,
        end: float = 0.02,
        img_channels: int = 3,
        dtype: Union[str, torch.dtype] = torch.float32,
        sample_steps: Optional[int] = None,
        **kwargs: Any,
    ):
        if model is None:
            # LitDDPM's default model is never built here, so the labels
            # must reach this one: an unconditional model would drop them
            model = iddpm_models.UNet(in_channels=img_channels, dtype=resolve_dtype(dtype),
                                      fused_norm=True, fused_block=True,
                                      num_classes=kwargs.get("num_classes"))
        if diffusion_model is None:
            diffusion_model = IDDPM.create(timesteps, loss_type, gamma, schedule, offset, start,
                                           end)
        self.strided = (diffusion_model.strided(sample_steps)
                        if sample_steps is not None else None)
        super().__init__(lr, warmup, decay, diffusion_model, model, timesteps,
                         img_channels=img_channels, dtype=dtype, **kwargs)

    def sample_algorithm(self):
        return self.diffusion_model if self.strided is None else self.strided


class LitEDM(LitDDPM):
    """EDM harness: continuous-σ preconditioned training (Karras et al. 2022)
    of the DDPM UNet, sampled with the second-order Heun solver in
    ``sample_steps`` steps (2·steps − 1 evaluations). The network is
    conditioned on the float c_noise(σ) through its time embedding; the
    other keyword arguments are :class:`LitDDPM`'s."""

    def __init__(
        self,
        lr: float = 1e-3,
        warmup: int = 5000,
        decay: float = 0.9999,
        diffusion_model: Optional[EDM] = None,
        model: Optional[torch.nn.Module] = None,
        sample_steps: int = 18,
        sigma_min: float = 0.002,
        sigma_max: float = 80.0,
        rho: float = 7.0,
        sigma_data: float = 0.5,
        p_mean: float = -1.2,
        p_std: float = 1.2,
        order: int = 2,
        s_churn: float = 0.0,
        **kwargs: Any,
    ):
        if diffusion_model is None:
            diffusion_model = EDM.create(steps=sample_steps, sigma_min=sigma_min,
                                         sigma_max=sigma_max, rho=rho, sigma_data=sigma_data,
                                         p_mean=p_mean, p_std=p_std, order=order,
                                         s_churn=s_churn)
        super().__init__(lr, warmup, decay, diffusion_model, model, **kwargs)


class LitFlow(LitDDPM):
    """Flow-matching / rectified-flow harness: straight-path velocity
    regression (:class:`~dmme_tpu_torch.diffusion.FlowMatching`) of the DDPM
    UNet, sampled by integrating the learned ODE with Euler (``order=1``) or
    the midpoint rule in ``sample_steps`` steps. The network is conditioned
    on ``t · 1000``; the other keyword arguments are :class:`LitDDPM`'s."""

    def __init__(
        self,
        lr: float = 2e-4,
        warmup: int = 5000,
        decay: float = 0.9999,
        diffusion_model: Optional[FlowMatching] = None,
        model: Optional[torch.nn.Module] = None,
        sample_steps: int = 25,
        order: int = 2,
        shift: float = 1.0,
        t_sample: str = "logit_normal",
        logit_mean: float = 0.0,
        logit_std: float = 1.0,
        **kwargs: Any,
    ):
        if diffusion_model is None:
            diffusion_model = FlowMatching.create(steps=sample_steps, order=order, shift=shift,
                                                  t_sample=t_sample, logit_mean=logit_mean,
                                                  logit_std=logit_std)
        super().__init__(lr, warmup, decay, diffusion_model, model, **kwargs)


class LitUpsampler(LitDDPM):
    """Super-resolution harness: denoises the high-resolution x_t conditioned
    on the low-resolution image, resized back up bilinearly and concatenated
    on channels (network input 2·C). Training pairs are made inside the loss:
    low = the exact ``factor``× average pool of the batch, cond = its
    bilinear resize to the batch's size. The conditioning enters only
    through a bound model_fn. The default network is the DDPM UNet with
    ``in_channels = 2·C`` and ``out_channels = C``; sampling needs the
    low-resolution input: ``generate(state, generator, low_res=...)``."""

    def __init__(self, factor: int = 4, model: Optional[torch.nn.Module] = None,
                 img_channels: int = 3, dtype: Union[str, torch.dtype] = torch.float32,
                 **kwargs: Any) -> None:
        self.factor = int(factor)
        if self.factor < 2:
            raise ValueError(f"factor must be at least 2, got {factor}")
        if kwargs.get("num_classes") is not None:
            # the labels would never reach the network: refuse them
            raise NotImplementedError(
                "LitUpsampler does not support num_classes yet; train an "
                "unconditional upsampler or use a class-conditional base "
                "model + unconditional upsampler (the common cascade setup)")
        if model is None:
            model = ddpm_models.UNet(in_channels=2 * img_channels, out_channels=img_channels,
                                     dtype=resolve_dtype(dtype), fused_norm=True,
                                     fused_block=True)
        super().__init__(model=model, img_channels=img_channels, dtype=dtype, **kwargs)

    def model_in_channels(self) -> int:
        return 2 * self.img_channels  # x_t ‖ the resized low-resolution image

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        """The exact ``factor``× average pool of NHWC ``x``."""
        n, h, w, c = x.shape
        f = self.factor
        if h % f or w % f:
            raise ValueError(f"image {tuple(x.shape)} is not divisible by factor {f}")
        return x.reshape(n, h // f, f, w // f, f, c).mean(dim=(2, 4))

    def bound_model_fn(self, cond: torch.Tensor, base_fn=None):
        """``base_fn`` (:meth:`model_fn` by default) with ``cond`` (already
        at the high resolution) concatenated to x_t on channels."""
        base_fn = self.model_fn if base_fn is None else base_fn

        def model_fn(params, x_t, t, **kwargs):
            return base_fn(params, torch.cat([x_t, cond.to(x_t.dtype)], dim=-1), t, **kwargs)

        return model_fn

    def make_loss_fn(self, datamodule=None):
        """The diffusion loss of the high-resolution batch conditioned on its
        own pooled-and-resized copy; draws as :meth:`LitDDPM.make_loss_fn`'s
        (flip, t, ε, dropout)."""

        def loss_fn(params, generator, batch):
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if datamodule is not None:
                x = datamodule.train_transform(generator, x)
            cond = resize_bilinear(self.downsample(x), x.shape[1:3])
            box: list = []
            loss = self.diffusion_model.loss(self.bound_model_fn(cond, self.loss_model_fn(box)),
                                             params, generator, x, train=True)
            return self.add_moe_aux(loss, box)

        return loss_fn

    @torch.no_grad()
    def eval_loss(self, params, generator: torch.Generator, x: torch.Tensor,
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.encode_eval(x)
        cond = resize_bilinear(self.downsample(x), x.shape[1:3])
        return self.diffusion_model.loss(self.bound_model_fn(cond), params, generator, x,
                                         train=False)

    def generate(self, state: TrainState, generator: Optional[torch.Generator],
                 img_shape: Optional[Tuple[int, ...]] = None, *,
                 low_res: Optional[torch.Tensor] = None, use_ema: Optional[bool] = None,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None,
                 y: Optional[torch.Tensor] = None):
        """Upsample ``low_res`` ((N, h, w, C) in [−1, 1]) to (N, h·factor,
        w·factor, C) with the harness's sampler. There is no unconditional
        call: without ``low_res`` it raises, as it does for an ``img_shape``
        other than the derived one. ``y`` is taken and ignored, as in JAX."""
        if low_res is None:
            raise ValueError(
                "LitUpsampler.generate needs low_res=(N, h, w, C) in [-1, 1] "
                "— an upsampler samples conditioned on a low-res input; see "
                "scripts/upsample_demo.py (the CLI sample/test subcommands "
                "have no conditioning source for upsampler configs)")
        n, h, w, c = low_res.shape
        out_shape = (n, h * self.factor, w * self.factor, c)
        if img_shape is not None and tuple(img_shape) != out_shape:
            raise ValueError(f"img_shape {tuple(img_shape)} conflicts with "
                             f"low_res×factor = {out_shape}; omit img_shape or fix low_res")
        if use_ema is None:
            use_ema = not self.validate_original_weights
        params = state.ema_params if use_ema else state.params
        device = next(iter(params.values())).device
        cond = resize_bilinear(low_res.to(device=device, dtype=torch.float32), out_shape[1:3])
        return self.sample_algorithm().generate(self.bound_model_fn(cond), params, generator,
                                                out_shape, x_T=x_T,
                                                history_length=history_length)


class LitDistill(LitDDPM):
    """Progressive-distillation harness: trains a student to halve the
    teacher's deterministic sampling steps
    (:class:`~dmme_tpu_torch.diffusion.distill.ProgressiveDistillation`)
    through the standard ``fit`` loop. The teacher's weights ride in the
    loss closure and run without gradient; :meth:`generate` and the
    callbacks sample with the student's N-step DDIM. The student is the
    teacher's module unless ``model`` is given, and starts from copies of
    ``init_params`` where given (the paper's practice for a v teacher);
    ``python -m dmme_tpu_torch.distill`` drives the rounds."""

    def __init__(self, teacher_model: torch.nn.Module, teacher_params: Dict[str, torch.Tensor],
                 distiller, model: Optional[torch.nn.Module] = None, lr: float = 1e-4,
                 warmup: int = 0, decay: float = 0.9999,
                 init_params: Optional[Dict[str, torch.Tensor]] = None, **kwargs: Any):
        if model is None:
            model = teacher_model  # the same architecture by default
        super().__init__(lr, warmup, decay, diffusion_model=distiller.student_sampler(),
                         model=model, **kwargs)
        self.distiller = distiller
        self.teacher_model = teacher_model
        self.teacher_params = teacher_params
        self.init_params = init_params

    def teacher_fn(self, params: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                   **kwargs) -> torch.Tensor:
        """The teacher's denoiser with ``params`` bound."""
        return functional_call(self.teacher_model, params, (x, t), kwargs)

    def init_state(self, generator: Union[int, torch.Generator] = 0,
                   device: Union[None, str, torch.device] = None) -> TrainState:
        """:meth:`LitDDPM.init_state`, then, with ``init_params``, parameters
        and EMA set to two copies of them: neither aliases the other nor the
        teacher (the step updates both in place)."""
        state = super().init_state(generator, device)
        if self.init_params is not None:
            device = next(iter(state.params.values())).device
            for dst in (state.params, state.ema_params):
                for k in dst:
                    dst[k] = self.init_params[k].detach().to(device=device,
                                                             dtype=dst[k].dtype).clone()
        return state

    def make_loss_fn(self, datamodule=None):
        """The distillation loss over raw batches: flip, process, then i, ε
        and the student's dropout from the step's generator; the student's
        router losses, if any, through :meth:`loss_model_fn` (the frozen
        teacher's routers need none)."""
        distillers = {}

        def loss_fn(params, generator, batch):
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if datamodule is not None:
                x = datamodule.train_transform(generator, x)
            if x.device not in distillers:  # the tables on the batch's device, once
                distillers[x.device] = self.distiller.to(x.device)
            box: list = []
            loss = distillers[x.device].loss(self.teacher_fn, self.teacher_params,
                                             self.loss_model_fn(box), params, generator, x,
                                             train=True)
            return self.add_moe_aux(loss, box)

        return loss_fn


def records_router_losses(model: torch.nn.Module) -> bool:
    """Whether ``model``'s forward takes a ``moe_losses`` list (a DiT)."""
    return "moe_losses" in inspect.signature(model.forward).parameters


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` resized to ``size`` (H, W) by bilinear interpolation at
    half-pixel centres, edges clamped: ``jax.image.resize(..., "linear")``
    for upscaling (downscaling there widens the kernel; this does not)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(v) for v in size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
