"""GenerateImage: sample grids during training (mirrors ``dmme_tpu/callbacks/generate.py``).

Every ``every_n_steps`` optimizer steps, and once when ``fit`` ends, the
harness samples ``num_samples`` trajectories with the EMA weights, keeps
``vis_length`` evenly spaced frames of each (``generate(history_length=)``)
and lays them out one trajectory a row. The grid goes to the logger
(``log_image``) and to ``<out_dir>/step_<step>.png``, or ``.npy`` where
the PNG cannot be written. On a mesh every rank calls it and rank 0 alone
samples and writes, from the gathered weights under fsdp; they are not
kept past the call.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from dmme_tpu_torch.training.loggers import _to_png
from dmme_tpu_torch.utils.norm import denorm
from dmme_tpu_torch.utils.vis import make_history


class GenerateImage:
    """Callback for :func:`dmme_tpu_torch.training.fit`.

    Args:
        imgsize: (C, H, W) as in the configs, or (H, W, C); kept as NHWC.
        every_n_steps: sampling cadence in optimizer steps.
        num_samples: trajectories a grid.
        vis_length: frames a trajectory.
        out_dir: where grids go; made on first use.
        use_ema: None follows the harness (``validate_original_weights``).
    """

    def __init__(self, imgsize: Sequence[int] = (3, 32, 32), every_n_steps: int = 2000,
                 num_samples: int = 8, vis_length: int = 10, out_dir: str = "samples",
                 use_ema: Optional[bool] = None):
        if len(imgsize) != 3:
            raise ValueError("imgsize must be (C,H,W) or (H,W,C)")
        c, h, w = imgsize
        if c > 4 and imgsize[2] <= 4:  # (H, W, C) given
            h, w, c = imgsize
        self.shape = (num_samples, h, w, c)
        self.every_n_steps = every_n_steps
        self.vis_length = vis_length
        self.out_dir = out_dir
        self.use_ema = use_ema

    def on_train_step_end(self, step: int, lit, state, logger=None) -> None:
        if step % self.every_n_steps != 0:
            return
        self.generate_and_save(step, lit, state, logger=logger)

    def on_fit_end(self, lit, state, logger=None) -> None:
        self.generate_and_save(int(state.step), lit, state, logger=logger)

    def generate_and_save(self, step: int, lit, state, logger=None) -> Optional[str]:
        """Sample from a generator seeded with ``step`` on the weights' device;
        returns the path written (None on a mesh's other ranks)."""
        mesh = getattr(state, "mesh", None)
        if mesh is not None:
            state = state.whole(moments=False)  # a collective where the state is sharded
            if mesh.rank != 0:
                return None
        device = next(iter(state.ema_params.values())).device
        generator = torch.Generator(device=device).manual_seed(int(step))
        _, history = lit.generate(state, generator, self.shape, use_ema=self.use_ema,
                                  history_length=self.vis_length)
        frames = denorm(history).to(torch.float32).cpu().numpy()  # (vis_length, N, H, W, C)
        grid = make_history(list(frames))
        if logger is not None and hasattr(logger, "log_image"):
            logger.log_image("samples", grid, step)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"step_{step:08d}")
        try:
            png, _, _, _ = _to_png(grid)
            with open(path + ".png", "wb") as f:
                f.write(png)
            return path + ".png"
        except Exception:  # noqa: BLE001 — keep the grid in some form
            np.save(path + ".npy", grid)
            return path + ".npy"
