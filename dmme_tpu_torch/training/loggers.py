"""Pluggable logger backends for scalars and images (a copy of
``dmme_tpu/training/loggers.py``, which imports nothing of JAX).

Three backends, composed by :class:`MultiLogger`:

* :class:`JsonlLogger`: scalars to ``<dir>/metrics.jsonl`` (one JSON object a
  step), images as PNGs under ``<dir>/images/``.
* :class:`TensorBoardLogger`: TensorBoard event files from a dependency-free
  encoder (TFRecord framing, masked CRC32C, hand-encoded Event/Summary
  protobufs); the bytes are the JAX package's for the same records.
* :class:`WandbLogger`: a thin wrapper that imports ``wandb`` when built and
  raises a clear ``ImportError`` without it.

Protocol (duck-typed): ``log_metrics(metrics: dict, step)``,
``log_image(tag, image, step)`` with an HWC uint8 or [0, 1] float image,
``finalize()``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------- crc32c
# Castagnoli CRC-32 (poly 0x1EDC6F41, reflected 0x82F63B78), the checksum
# TFRecord framing uses; table-driven.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ protobuf encode
# Minimal writers for the two message shapes TensorBoard needs. Field layout
# from tensorboard's event.proto / summary.proto (stable public format):
#   Event:   1=wall_time(double) 2=step(int64) 3=file_version(string)
#            5=summary(Summary)
#   Summary: 1=value(repeated Value)
#   Value:   1=tag(string) 2=simple_value(float) 4=image(Image)
#   Image:   1=height 2=width 3=colorspace 4=encoded_image_string(bytes)


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # two's complement for negatives
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _str(field: int, v: str) -> bytes:
    return _bytes(field, v.encode("utf-8"))


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    out = _f64(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version is not None:
        out += _str(3, file_version)
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes(1, _str(1, tag) + _f32(2, float(value)))


def _image_value(tag: str, png: bytes, h: int, w: int, channels: int) -> bytes:
    colorspace = {1: 1, 3: 3, 4: 6}.get(channels, 3)
    img = _int(1, h) + _int(2, w) + _int(3, colorspace) + _bytes(4, png)
    return _bytes(1, _str(1, tag) + _bytes(4, img))


def _to_png(image: np.ndarray) -> tuple:
    """HWC (or HW) uint8/float image → (png_bytes, h, w, c). PIL preferred;
    falls back to an uncompressed from-scratch PNG encoder (zlib stored
    blocks) so image logging never needs an optional dep."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr[..., 0] if c == 1 else arr).save(buf, format="PNG")
        return buf.getvalue(), h, w, c
    except Exception:
        return _png_encode(arr), h, w, c


def _png_encode(arr: np.ndarray) -> bytes:
    """Minimal valid PNG (8-bit gray/RGB/RGBA, zlib stored blocks)."""
    import zlib

    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 0))
        + chunk(b"IEND", b"")
    )


# ------------------------------------------------------------------- backends
class JsonlLogger:
    """Scalars to ``<dir>/<name>.jsonl``; images to ``<dir>/images/``."""

    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._file = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_image(self, tag: str, image, step: int) -> str:
        png, _, _, _ = _to_png(image)
        d = os.path.join(self.log_dir, "images")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{tag.replace('/', '_')}_{step:08d}.png")
        with open(path, "wb") as f:
            f.write(png)
        return path

    def finalize(self) -> None:
        self._file.close()


class TensorBoardLogger:
    """Event-file writer with zero dependencies (see module docstring)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        ts = time.time()
        fname = f"events.out.tfevents.{int(ts)}.dmme_tpu_torch"
        self._file = open(os.path.join(log_dir, fname), "ab")
        self._write(_event(ts, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + event
            + struct.pack("<I", _masked_crc(event))
        )
        self._file.flush()

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        values = b""
        for k, v in metrics.items():
            try:
                values += _scalar_value(k, float(v))
            except (TypeError, ValueError):
                continue
        if values:
            self._write(_event(time.time(), step=int(step), summary=values))

    def log_image(self, tag: str, image, step: int) -> None:
        png, h, w, c = _to_png(image)
        self._write(
            _event(time.time(), step=int(step),
                   summary=_image_value(tag, png, h, w, c))
        )

    def finalize(self) -> None:
        self._file.close()


class WandbLogger:
    """Weights & Biases backend. Imports ``wandb`` when constructed and
    raises a clear ``ImportError`` where it is not installed, so configs
    that do not ask for it never pay the import."""

    def __init__(self, project: str = "dmme_tpu", name: Optional[str] = None,
                 **init_kwargs):
        try:
            import wandb
        except ImportError as e:  # pragma: no cover - wandb not in test env
            raise ImportError(
                "WandbLogger requires the 'wandb' package (pip install wandb)"
            ) from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, **init_kwargs)

    def log_metrics(self, metrics, step):  # pragma: no cover - needs wandb
        self._run.log(dict(metrics), step=int(step))

    def log_image(self, tag, image, step):  # pragma: no cover - needs wandb
        self._run.log({tag: self._wandb.Image(np.asarray(image))}, step=int(step))

    def finalize(self):  # pragma: no cover - needs wandb
        self._run.finish()


class MultiLogger:
    """Fan-out to several backends; the shape ``fit()`` consumes."""

    def __init__(self, loggers: Sequence[Any]):
        self.loggers = list(loggers)

    def log_metrics(self, metrics, step):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_image(self, tag, image, step):
        for lg in self.loggers:
            lg.log_image(tag, image, step)

    def finalize(self):
        for lg in self.loggers:
            lg.finalize()
