"""Scalar and image metric logging (mirrors ``dmme_tpu/training/metrics.py``).

``MetricLogger`` is what the training loop talks to: it composes the
backends of :mod:`dmme_tpu_torch.training.loggers` (JSONL when a ``log_dir``
is given, TensorBoard event files on request, or an explicit list) and
echoes each record to stderr as ``[step N] time=… key=value …``. Metric
tensors are read (``float``) only here, at log boundaries, so the training
loop does not wait for the device between them.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

from dmme_tpu_torch.training.loggers import JsonlLogger, MultiLogger, TensorBoardLogger


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "metrics",
                 tensorboard: bool = False, loggers: Optional[Sequence[Any]] = None):
        """``loggers`` replaces the default backends; else JSONL (with a
        ``log_dir``) and TensorBoard under ``<log_dir>/tb`` (if asked)."""
        if loggers is None:
            loggers = []
            if log_dir is not None:
                loggers.append(JsonlLogger(log_dir, name))
                if tensorboard:
                    loggers.append(TensorBoardLogger(os.path.join(log_dir, "tb")))
        self._multi = MultiLogger(loggers)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], echo: bool = True) -> Dict[str, Any]:
        """Write one record; returns it with every value that converts as a float."""
        record: Dict[str, Any] = {}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._multi.log_metrics(record, step)
        if echo:
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items())
            print(f"[step {step}] time={time.time() - self._t0:.3f} {parts}", file=sys.stderr)
        return record

    def log_image(self, tag: str, image, step: int) -> None:
        self._multi.log_image(tag, image, step)

    def close(self) -> None:
        self._multi.finalize()
