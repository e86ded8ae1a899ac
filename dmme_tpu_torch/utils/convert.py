"""The JAX package's parameter tree → this port's ``state_dict``.

``from_flax`` takes ``jax.tree_util.tree_map(np.asarray, variables)`` — nested
dicts of numpy arrays, with or without the top-level ``"params"`` — and
returns tensors keyed as the port's modules name them: conv kernels HWIO →
OIHW, Dense kernels (in, out) → (out, in), GroupNorm ``scale`` and
``nn.Embed``'s ``embedding`` → ``weight``.
It is the reverse of ``dmme_tpu/utils/torch_convert.py``, written anew here.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch


def _leaf(name: str, value) -> tuple:
    a = np.asarray(value)
    if name == "kernel":
        if a.ndim == 4:  # HWIO -> OIHW
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 2:  # (in, out) -> (out, in)
            return "weight", a.T
        raise ValueError(f"kernel of rank {a.ndim} has no counterpart")
    if name in ("scale", "embedding"):  # GroupNorm scale; nn.Embed's (rows, features) table
        return "weight", a
    if name == "bias":
        return "bias", a
    raise ValueError(f"parameter {name!r} has no counterpart in the port")


def from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a flax params tree into a ``state_dict`` for ``load_state_dict``."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:
                name, arr = _leaf(key, value)
                out[prefix + name] = torch.tensor(arr, dtype=torch.float32)

    walk(tree, "")
    return out
