"""Training and sampling harnesses, the training loop and what it drives
(mirrors ``dmme_tpu.training``): ``LitDDPM``/``LitDDIM``/``LitIDDPM``/``LitEDM``/
``LitFlow``/``LitUpsampler``/``LitDistill``, the noisy classifier's ``LitClassifier``
(``classifier``), ``TrainState``, ``fit`` (``loop``), ``CheckpointManager``
(``checkpoint``), ``MetricLogger`` (``metrics``) over the JSONL/TensorBoard/W&B
backends of ``loggers``, and ``validate`` (``evaluate``)."""

from dmme_tpu_torch.training.checkpoint import CheckpointManager
from dmme_tpu_torch.training.classifier import LitClassifier
from dmme_tpu_torch.training.ema import ema_update
from dmme_tpu_torch.training.evaluate import validate
from dmme_tpu_torch.training.lit import (LitDDIM, LitDDPM, LitDistill, LitEDM, LitFlow,
                                         LitIDDPM, LitUpsampler)
from dmme_tpu_torch.training.loggers import (JsonlLogger, MultiLogger, TensorBoardLogger,
                                             WandbLogger)
from dmme_tpu_torch.training.loop import fit
from dmme_tpu_torch.training.lr_schedule import warmup_schedule
from dmme_tpu_torch.training.metrics import MetricLogger
from dmme_tpu_torch.training.state import TrainState

__all__ = ["LitDDPM", "LitDDIM", "LitIDDPM", "LitEDM", "LitFlow", "LitUpsampler", "LitDistill",
           "LitClassifier", "TrainState", "fit", "validate", "warmup_schedule",
           "ema_update", "CheckpointManager", "MetricLogger", "JsonlLogger",
           "TensorBoardLogger", "WandbLogger", "MultiLogger"]
