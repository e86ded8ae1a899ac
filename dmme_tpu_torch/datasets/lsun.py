"""LSUN LMDB datasets (mirrors ``dmme_tpu/datasets/lsun.py``).

Same behaviours as the JAX package's, with no torchvision or ``lmdb``
dependency:

* ``LSUNClass`` — one category's LMDB; keys are cached to a ``_cache_*``
  pickle next to the data on first validated open, with a validation pass
  that skips any value that fails to decode as an image; an unvalidated
  (streaming) open neither reads nor writes the cache.
* ``LSUN`` — multi-category concat with cumulative-index routing and the
  known-corrupt key blacklist of the ``cat`` category.

Decoding uses PIL; samples come back as uint8 HWC numpy arrays.
"""

from __future__ import annotations

import io
import os
import pickle
import string
from typing import Callable, List, Optional, Sequence

import numpy as np

from dmme_tpu_torch.data.lmdb_reader import open_lmdb

SCENES = [
    "bedroom",
    "bridge",
    "church_outdoor",
    "classroom",
    "conference_room",
    "dining_room",
    "kitchen",
    "living_room",
    "restaurant",
    "tower",
]

OBJECTS = [
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "dining_table", "dog", "horse", "motorbike", "person",
    "potted_plant", "sheep", "sofa", "train", "tv-monitor",
]

# Known-corrupt keys in the official cat archive, byte for byte the JAX
# package's.
CORRUPT_KEYS = {
    "cat": {
        b"05c509a12295c0725be85566680c58c81965ea63",
        b"0ec91d487375c2663a43d463f9e5b4e34b8527aa",
    }
}


def _decode_image(buf) -> Optional[np.ndarray]:
    """The RGB uint8 HWC pixels of an encoded image, or None where the bytes
    do not decode as one."""
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(bytes(buf)))
        img.load()
        return np.asarray(img.convert("RGB"), np.uint8)
    except Exception:  # noqa: BLE001 — whatever PIL raises marks the value corrupt, as in JAX
        return None


class LSUNClass:
    """One LSUN category LMDB with cached, validated keys."""

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        blacklist: Sequence[bytes] = (),
        validate: bool = True,
    ):
        self.root = root
        self.transform = transform
        self.reader = open_lmdb(root)

        cache_name = "_cache_" + "".join(
            c for c in root if c in string.ascii_letters + string.digits
        )
        cache_path = os.path.join(
            os.path.dirname(os.path.abspath(root)) or ".", cache_name
        )
        # the pickled key cache only ever holds VALIDATED key lists — an
        # unvalidated (streaming) open must not poison later validated opens
        if validate and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                self.keys: List[bytes] = pickle.load(f)
        else:
            blacklist = set(blacklist)
            keys = []
            for k, v in self.reader.items():
                if k in blacklist:
                    continue
                if validate and _decode_image(v) is None:
                    continue
                keys.append(k)
            self.keys = keys
            if validate:
                with open(cache_path, "wb") as f:
                    pickle.dump(self.keys, f)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> np.ndarray:
        buf = self.reader.get(self.keys[index])
        img = _decode_image(buf)
        if img is None:
            raise IOError(f"undecodable value for key {self.keys[index]!r}")
        if self.transform is not None:
            img = self.transform(img)
        return img


class LSUN:
    """Concat of per-category LSUN datasets with cumulative-index routing.

    ``classes``: "train"/"val"/"test", or a list like ["bedroom_train"].
    """

    def __init__(
        self,
        root: str,
        classes="train",
        transform: Optional[Callable] = None,
    ):
        self.root = root
        self.classes = self._resolve(classes)
        self.dbs = []
        for c in self.classes:
            category = c.rsplit("_", 1)[0]
            self.dbs.append(
                LSUNClass(
                    os.path.join(root, f"{c}_lmdb"),
                    transform=transform,
                    blacklist=CORRUPT_KEYS.get(category, ()),
                )
            )
        self.indices = np.cumsum([len(db) for db in self.dbs])

    @staticmethod
    def _resolve(classes) -> List[str]:
        if isinstance(classes, str):
            if classes not in ("train", "val", "test"):
                raise ValueError(f"unknown split {classes!r}")
            if classes == "test":
                return ["test"]
            return [f"{c}_{classes}" for c in SCENES]
        return list(classes)

    def __len__(self) -> int:
        return int(self.indices[-1]) if len(self.dbs) else 0

    def __getitem__(self, index: int):
        db_idx = int(np.searchsorted(self.indices, index, side="right"))
        prev = 0 if db_idx == 0 else int(self.indices[db_idx - 1])
        return self.dbs[db_idx][index - prev]
