"""``LitClassifier``: noisy-classifier training (mirrors ``dmme_tpu/training/classifier.py``).

Classifier guidance (:mod:`dmme_tpu_torch.diffusion.guidance`) needs a
classifier of noisy images p_φ(y | x_t, t). This harness trains
:class:`~dmme_tpu_torch.models.adm.EncoderUNet` with cross-entropy on
q-sampled inputs at uniformly drawn timesteps, the ADM recipe, through the
same ``TrainState``/``fit`` machinery as the diffusion harnesses. Batches
are labelled: ``(uint8 images, int labels)`` from a data module built with
``with_labels=True``.

The optimizer is JAX's ``optax.chain(clip_by_global_norm(grad_clip),
adamw(warmup_schedule(lr, warmup), weight_decay=0.05))``: the decay reaches
every parameter (:class:`~dmme_tpu_torch.training.optimizer.ClipAdam`).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion import DDPM
from dmme_tpu_torch.diffusion.ddpm import _bcast
from dmme_tpu_torch.models import adm, init_weights
from dmme_tpu_torch.training.lit import resolve_dtype
from dmme_tpu_torch.training.lr_schedule import warmup_schedule
from dmme_tpu_torch.training.optimizer import ClipAdam
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.device import resolve_device

#: AdamW's decay of the classifier recipe (``dmme_tpu/training/classifier.py:61``)
WEIGHT_DECAY = 0.05


class LitClassifier:
    """The noisy-classifier harness: the optimizer recipe and the loss. The
    default model is ``adm.classifier(image_size, num_classes, dtype)``; t
    is drawn from ``diffusion_model`` (default ``DDPM.create(timesteps)``)."""

    def __init__(
        self,
        lr: float = 3e-4,
        warmup: int = 1000,
        decay: float = 0.9999,
        model: Optional[torch.nn.Module] = None,
        diffusion_model: Optional[DDPM] = None,
        timesteps: int = 1000,
        num_classes: int = 10,
        image_size: int = 32,
        grad_clip: float = 1.0,
        img_channels: int = 3,
        dtype: Union[str, torch.dtype] = torch.float32,
    ):
        self.lr = lr
        self.warmup = warmup
        self.decay = decay
        self.grad_clip = grad_clip
        self.img_channels = img_channels
        if model is None:
            model = adm.classifier(image_size=image_size, num_classes=num_classes,
                                   dtype=resolve_dtype(dtype))
        self.model = model
        if diffusion_model is None:
            diffusion_model = DDPM.create(timesteps)
        self.diffusion_model = diffusion_model

    def make_optimizer(self) -> ClipAdam:
        """Global-norm clip at ``grad_clip``, then AdamW (decay 0.05) at the
        warmup schedule."""
        return ClipAdam(self.grad_clip, warmup_schedule(self.lr, self.warmup),
                        weight_decay=WEIGHT_DECAY)

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
        return TrainState.create(params, self.make_optimizer(), ema_decay=self.decay)

    def model_fn(self, params: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
                 **kwargs) -> torch.Tensor:
        """The classifier with ``params`` bound: ``model(x, t, **kwargs)``."""
        return functional_call(self.model, params, (x, t), kwargs)

    def make_loss_fn(self, datamodule=None):
        """``loss_fn(params, generator, (images, labels))``: the datamodule's
        augment → process (where given), then :meth:`loss_given` with t, ε
        and the model's dropout drawn from ``generator``, in the order of
        the JAX package's key splits: flip, t, ε, dropout."""
        algo = self.diffusion_model

        def loss_fn(params, generator, batch):
            x_0, y = batch
            if datamodule is not None:
                x_0 = datamodule.train_transform(generator, x_0)
            t = algo.sample_timesteps(generator, x_0.shape[0])
            noise = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                                device=generator.device)
            return self.loss_given(params, x_0, y, t, noise, train=True, generator=generator)

        return loss_fn

    def loss_given(self, params, x_0: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Mean cross-entropy of the f32 logits at x_t = q_sample(x_0, ᾱ_t, ε)
        against ``y``: the deterministic core of the loss."""
        ab_t = _bcast(self.diffusion_model.schedule.alpha_bar.to(x_0.device)[t], x_0.dim())
        x_t = eq.ddpm.q_sample(x_0, ab_t, noise)
        logits = self.model_fn(params, x_t, t, train=train, generator=generator)
        return F.cross_entropy(logits.to(torch.float32), y.to(torch.int64))

    @torch.no_grad()
    def accuracy(self, params, batch, t_value: int = 1) -> torch.Tensor:
        """Accuracy on ``(x_0, labels)`` at the fixed small t ``t_value``, x_0
        fed as it is (no noise is drawn, so JAX's unused ``rng`` is not
        taken)."""
        x_0, y = batch
        t = torch.full((x_0.shape[0],), t_value, dtype=torch.int64, device=x_0.device)
        logits = self.model_fn(params, x_0, t)
        return torch.mean((torch.argmax(logits, -1) == y.to(logits.device)).to(torch.float32))
