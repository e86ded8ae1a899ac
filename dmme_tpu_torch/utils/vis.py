"""Sample-grid visualisation in numpy (mirrors ``dmme_tpu/utils/vis.py``).

Images are NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def make_grid(images, nrow: int = 8, padding: int = 2, pad_value: float = 0.0):
    """Tile a batch of NHWC images into one (H', W', C) grid image
    (the layout of ``torchvision.utils.make_grid``, without normalisation)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = int(math.ceil(n / ncol))
    grid = np.full(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        pad_value, dtype=images.dtype,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def make_history(history: Sequence):
    """Lay out a diffusion trajectory: one frame is tiled into a near-square
    grid; several frames give one trajectory per row, time left to right."""
    history = [np.asarray(x) for x in history]
    if len(history) == 1:
        img = history[-1]
        batch_size = img.shape[0]
        nrow = 1
        for i in range(int(math.sqrt(batch_size)), 2, -1):
            if batch_size % i == 0:
                nrow = batch_size // i
                break
        return make_grid(img, nrow=nrow)

    stacked = np.stack(history, axis=1)  # (N, T_vis, H, W, C)
    n, t = stacked.shape[:2]
    return make_grid(stacked.reshape((n * t,) + stacked.shape[2:]), nrow=t)
