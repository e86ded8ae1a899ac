"""Sampling server: serve a diffusion model over HTTP (mirrors ``dmme_tpu/serving.py``).

* ``GET  /healthz``          → ``{"status": "ok", "step": N, ...}``
* ``POST /sample`` JSON body → PNG grid or raw ``.npy`` bytes
      {"n": 4,                # samples (rounded up to a batch bucket)
       "sampler": "dpm",      # default | ddim | dpm | unipc | edm | flow
                              # | cached | deep | deep_dpm
       "steps": 20,           # solver steps (the sampler's default if absent)
       "seed": 0,
       "format": "png"}       # png (grid) | npy ((n,H,W,C) float32 [0,1])

The stdlib ``ThreadingHTTPServer`` takes connections concurrently; generation
runs under one lock, one device. Batch sizes are bucketed to powers of two.
``default`` is the harness's own sampler; ``ddim``, ``dpm`` and ``unipc``
override it on the trained schedule, ``edm`` and ``flow`` on an EDM or
flow-matching model's trained hyperparameters, and ``cached``, ``deep`` and
``deep_dpm`` with the feature-caching samplers on the UNet module
(:mod:`dmme_tpu_torch.diffusion.factory`). A name the model's family does not
take is answered with 400.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np
import torch

from dmme_tpu_torch.diffusion.factory import MODULE_SAMPLERS, STEP_DEFAULTS, check_sampler
from dmme_tpu_torch.utils.device import resolve_device
from dmme_tpu_torch.utils.norm import denorm
from dmme_tpu_torch.utils.vis import make_history

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
#: the sampler names GET /healthz lists, as the JAX package's server lists
#: them: it answers ``flow`` too, but does not list it
SAMPLERS = ("default", *(n for n in STEP_DEFAULTS if n != "flow"), *MODULE_SAMPLERS)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class Sampler:
    """Serves samples of ``lit`` with the weights of ``state`` on one device.
    ``refresh_interval`` and ``cache_depth`` configure the feature-caching
    samplers (``trainer.refresh_interval`` / ``trainer.cache_depth``)."""

    def __init__(self, lit, state, img_size: int,
                 device: Union[None, str, torch.device] = None, refresh_interval: int = 2,
                 cache_depth: int = 1):
        self.lit = lit
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self.img_size = int(img_size)
        self.refresh_interval = int(refresh_interval)
        self.cache_depth = int(cache_depth)
        self.step = int(state.step)
        self._lock = threading.Lock()

    def sample(self, n: int, sampler: str = "default",
               steps: Optional[int] = None, seed: int = 0) -> np.ndarray:
        """(n, H, W, C) float32 in [0, 1]."""
        if not 1 <= n <= _BUCKETS[-1]:
            raise ValueError(f"n must be in [1, {_BUCKETS[-1]}], got {n}")
        if sampler != "default":
            check_sampler(sampler)
        shape = self.lit.sample_space_shape(
            (_bucket(n), self.img_size, self.img_size, self.lit.img_channels))
        with self._lock:  # one device: serialise generation
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
            out = self.lit.to_images(self.lit.generate(
                self.state, generator, shape, steps=steps,
                sampler=None if sampler == "default" else sampler,
                refresh_interval=self.refresh_interval, cache_depth=self.cache_depth))
            out = denorm(out).to(torch.float32).cpu().numpy()
        return out[:n]


def _png_bytes(images: np.ndarray) -> bytes:
    grid = make_history([images])
    from PIL import Image

    img = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = img[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _npy_bytes(images: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def make_server(sampler: Sampler, host: str = "127.0.0.1", port: int = 8000):
    """Build (not start) a ThreadingHTTPServer bound to (host, port);
    ``port=0`` picks an ephemeral port (see ``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {
                "status": "ok",
                "step": sampler.step,
                "img_size": sampler.img_size,
                "device": str(sampler.device),
                "samplers": list(SAMPLERS),
            })

        def do_POST(self):
            if self.path != "/sample":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                fmt = str(req.get("format", "png"))
                if fmt not in ("npy", "png"):
                    return self._json(400, {"error": f"unknown format {fmt!r}"})
                images = sampler.sample(
                    n=int(req.get("n", 1)),
                    sampler=str(req.get("sampler", "default")),
                    steps=req.get("steps"),
                    seed=int(req.get("seed", 0)),
                )
                if fmt == "npy":
                    body, ctype = _npy_bytes(images), "application/octet-stream"
                else:
                    body, ctype = _png_bytes(images), "image/png"
            except (ValueError, KeyError, TypeError, NotImplementedError,
                    json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the client must get an answer
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(sampler: Sampler, host: str = "127.0.0.1", port: int = 8000):
    server = make_server(sampler, host, port)
    print(f"serving on http://{server.server_address[0]}:{server.server_address[1]}")
    server.serve_forever()
