"""Procedural shapes dataset (mirrors ``dmme_tpu/data/shapes.py``).

One anti-aliased disc or square of a random palette colour on a dark
background, rendered from a seed in numpy: a structured distribution a
diffusion model visibly learns, with no dataset on disk. The renderer is the
JAX package's, line for line, so a seed gives the same bytes in both.
"""

from __future__ import annotations

import numpy as np
import torch

from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip

# bright foreground palette / dark background palette (uint8 RGB)
_FG = np.array(
    [
        [231, 76, 60],   # red
        [46, 204, 113],  # green
        [52, 152, 219],  # blue
        [241, 196, 15],  # yellow
        [155, 89, 182],  # purple
        [230, 126, 34],  # orange
        [26, 188, 156],  # teal
        [236, 240, 241], # white
    ],
    dtype=np.float32,
)
_BG = np.array(
    [[25, 28, 36], [40, 30, 30], [28, 38, 30], [35, 35, 25]],
    dtype=np.float32,
)


def render_shapes(n: int, img_size: int = 32, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 (n, s, s, 3), labels int32 (n,)): label 0 = disc,
    1 = square. Every random number is drawn up front, so the bytes do not
    depend on the render chunking."""
    rng = np.random.default_rng(seed)
    s = img_size
    shape_kind = rng.integers(0, 2, n).astype(np.int32)
    fg = _FG[rng.integers(0, len(_FG), n)]          # (n, 3)
    bg = _BG[rng.integers(0, len(_BG), n)]          # (n, 3)
    cx = rng.uniform(s * 0.3, s * 0.7, n).astype(np.float32)
    cy = rng.uniform(s * 0.3, s * 0.7, n).astype(np.float32)
    r = rng.uniform(s * 0.12, s * 0.3, n).astype(np.float32)

    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)  # (s, s)
    out = np.empty((n, s, s, 3), np.uint8)
    # chunks cap the (chunk, s, s) float32 temporaries at ~64 MB each
    chunk = max(1, min(n, (1 << 26) // (s * s * 4)))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        dx = xx[None] - cx[lo:hi, None, None]       # (chunk, s, s)
        dy = yy[None] - cy[lo:hi, None, None]
        dist_disc = np.sqrt(dx * dx + dy * dy)
        dist_square = np.maximum(np.abs(dx), np.abs(dy))
        dist = np.where(shape_kind[lo:hi, None, None] == 0, dist_disc, dist_square)
        # 1px anti-aliased edge
        alpha = np.clip(r[lo:hi, None, None] + 0.5 - dist, 0.0, 1.0)[..., None]
        img = bg[lo:hi, None, None, :] * (1 - alpha) + fg[lo:hi, None, None, :] * alpha
        out[lo:hi] = np.clip(img, 0, 255).astype(np.uint8)
    return out, shape_kind


class Shapes(DataModule):
    """Procedural discs-and-squares data module."""

    img_size = 32

    def __init__(self, size: int = 50_000, batch_size: int = 128, img_size: int = 32,
                 seed: int = 0, horizontal_flip: bool = True, with_labels: bool = False):
        super().__init__(batch_size)
        self.size = size
        self.img_size = img_size
        self.seed = seed
        self.horizontal_flip = horizontal_flip
        self.with_labels = with_labels

    def setup_train(self) -> None:
        if self.train_data is None:
            images, labels = render_shapes(self.size, self.img_size, self.seed)
            self.train_data = images
            if self.with_labels:
                self.train_labels = labels

    def setup_test(self) -> None:
        # the test stage reuses the train set without augmentation, as in JAX
        self.setup_train()
        self.test_data = self.train_data
        self.test_labels = self.train_labels

    def augment(self, generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
        if not self.horizontal_flip:
            return batch
        return random_horizontal_flip(generator, batch)
