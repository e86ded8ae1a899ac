"""Scalar metric logging (mirrors ``dmme_tpu/training/metrics.py``, JSONL only).

Each record goes to ``<log_dir>/<name>.jsonl`` when a ``log_dir`` is given,
and is echoed to stderr as ``[step N] time=… key=value …``. Metric tensors
are read (``float``) only here, at log boundaries, so the training loop
does not wait for the device between them.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "metrics"):
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], echo: bool = True) -> Dict[str, Any]:
        """Write one record; returns it with every value that converts as a float."""
        record: Dict[str, Any] = {}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        elapsed = time.time() - self._t0
        if self._file is not None:
            self._file.write(json.dumps({"step": int(step), "time": round(elapsed, 3), **record})
                             + "\n")
            self._file.flush()
        if echo:
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items())
            print(f"[step {step}] time={elapsed:.3f} {parts}", file=sys.stderr)
        return record

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
