"""Training and sampling harnesses and the training loop (mirrors ``dmme_tpu.training``)."""

from dmme_tpu_torch.training.ema import ema_update
from dmme_tpu_torch.training.lit import LitDDIM, LitDDPM
from dmme_tpu_torch.training.loop import fit
from dmme_tpu_torch.training.lr_schedule import warmup_schedule
from dmme_tpu_torch.training.metrics import MetricLogger
from dmme_tpu_torch.training.state import TrainState

__all__ = ["LitDDPM", "LitDDIM", "TrainState", "fit", "warmup_schedule", "ema_update",
           "MetricLogger"]
