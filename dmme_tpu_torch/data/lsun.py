"""LSUN data module (mirrors ``dmme_tpu/data/lsun.py``).

Category resolution, the resize→center-crop transform (shorter side to
``imgsize``, then the centre square, PIL bilinear) and the download logic
(``aria2c -x16 -s16`` + zip extract, skip-if-exists) are the JAX
package's. Download is opt-in (``download=True``); without it a missing
LMDB raises naming where to place it.

Two modes, both decoding on a THREAD pool (libjpeg and PIL release the GIL
in the C decode, and forking after CUDA initialises is a hazard); the
threads return uint8 numpy arrays and never touch the device, and the
training loop moves batches to the card as it does for CIFAR-10:

* ``streaming=True`` (auto for categories past ``streaming_threshold``
  entries): no up-front decode. Each epoch shuffles indices; batches are
  JPEG-decoded on demand with one in-flight prefetch batch, so RSS stays
  O(batch) even for the 3M-image bedroom category. Corrupt values (beyond
  the known blacklist) are replaced by resampling from their own stream.
* ``streaming=False``: chunked parallel decode into an on-disk memmap
  (``numpy.lib.format.open_memmap``): bounded RSS during the build, and
  later epochs are memory-mapped reads.

Both modes feed the same on-device flip and normalisation and yield each
process's slice of a global batch with ``train_iter(process_index=,
process_count=)``.
"""

from __future__ import annotations

import os
import subprocess
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip
from dmme_tpu_torch.data.lmdb_reader import open_lmdb
from dmme_tpu_torch.datasets.lsun import (
    CORRUPT_KEYS,
    LSUNClass,
    OBJECTS,
    SCENES,
    _decode_image,
)


def resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Shorter-side resize to ``size`` then center crop (torchvision
    Resize+CenterCrop semantics) using PIL bilinear."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
    pil = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(pil, np.uint8)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return arr[top : top + size, left : left + size]


def _decode_key(reader, key: bytes, size: int) -> Optional[np.ndarray]:
    """LMDB get → JPEG decode → resize/crop. Thread-safe: the reader is a
    read-only mmap with stateless lookups, and PIL/libjpeg release the GIL
    inside the C decode, so a thread pool gets real parallelism."""
    buf = reader.get(key)
    if buf is None:
        return None
    img = _decode_image(buf)
    if img is None:
        return None
    return resize_center_crop(img, size)


class LSUN(DataModule):
    def __init__(
        self,
        data_dir: str = ".",
        category: str = "bedroom",
        split: str = "train",
        batch_size: int = 2,
        imgsize: int = 256,
        horizontal_flip: bool = True,
        cache_decoded: bool = True,
        limit: Optional[int] = None,
        download: bool = False,
        streaming: Optional[bool] = None,
        streaming_threshold: int = 200_000,
        num_workers: Optional[int] = None,
        decode_chunk: int = 1024,
    ):
        super().__init__(batch_size)
        if category not in SCENES and category not in OBJECTS:
            raise ValueError(
                f"unknown LSUN category {category!r}; scenes={SCENES}, "
                f"objects={OBJECTS}"
            )
        self.data_dir = data_dir
        self.category = category
        self.split = split
        self.imgsize = imgsize
        self.img_size = imgsize
        self.horizontal_flip = horizontal_flip
        self.cache_decoded = cache_decoded
        self.limit = limit
        self.download = download
        self.streaming = streaming
        self.streaming_threshold = streaming_threshold
        self.num_workers = num_workers or (os.cpu_count() or 1)
        self.decode_chunk = decode_chunk
        self._stream_ds: Optional[LSUNClass] = None
        self._stream_n = 0

    @property
    def lmdb_path(self) -> str:
        # scenes share ONE test archive (test_lmdb, no category prefix);
        # objects ship as a single-category archive without split suffix
        if self.category in SCENES:
            name = (
                "test_lmdb"
                if self.split == "test"
                else f"{self.category}_{self.split}_lmdb"
            )
        else:
            name = f"{self.category}_lmdb"
        return os.path.join(self.data_dir, name)

    # -------------------------------------------------------------- download
    def prepare_data(self) -> None:
        if os.path.exists(self.lmdb_path):
            return
        if not self.download:
            raise FileNotFoundError(
                f"LSUN LMDB not found at {self.lmdb_path}. Pass download=True "
                "to fetch it (aria2c), or place the extracted "
                f"*_lmdb directory under {self.data_dir!r}. NOTE: this build "
                "environment has no network egress."
            )
        if self.category in SCENES:
            out_name = (
                "test_lmdb.zip"
                if self.split == "test"
                else f"{self.category}_{self.split}_lmdb.zip"
            )
            url = f"http://dl.yf.io/lsun/scenes/{out_name}"
        else:
            out_name = f"{self.category}.zip"
            url = f"http://dl.yf.io/lsun/objects/{out_name}"
        self._download_url(url, self.data_dir, out_name)

    def _download_url(self, url: str, out_dir: str, out_name: str) -> None:
        """aria2c download + zip extract, skip-if-exists: a non-zero aria2c
        exit or a corrupt or partial zip is removed and reported instead of
        wedging every later run."""
        if os.path.exists(self.lmdb_path):
            print("File exists skipping download")
            return
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, out_name)
        if not os.path.exists(out_path):
            print(f"Downloading {out_name}...")
            try:
                rc = subprocess.call(
                    ["aria2c", "-x", "16", "-s", "16", url, "-o", out_path]
                )
            except FileNotFoundError as e:
                raise RuntimeError(
                    "aria2c is not installed (the reference's downloader); "
                    f"install it or fetch {url} manually into {out_dir}"
                ) from e
            if rc != 0:
                if os.path.exists(out_path):
                    os.remove(out_path)  # never leave a partial archive
                raise RuntimeError(f"aria2c failed (exit {rc}) for {url}")
        print(f"Extracting {out_name}...")
        try:
            with zipfile.ZipFile(out_path) as f:
                f.extractall(out_dir)
        except zipfile.BadZipFile:
            os.remove(out_path)
            raise RuntimeError(
                f"{out_path} was corrupt (partial download?) — removed; "
                "re-run to download again"
            )
        if not os.path.exists(self.lmdb_path):
            # some official archives extract without the _lmdb suffix;
            # normalize to the directory the reader expects
            alt = os.path.join(out_dir, out_name.split(".")[0])
            if os.path.isdir(alt):
                os.rename(alt, self.lmdb_path)

    # ----------------------------------------------------------------- setup
    def _dataset(self, validate: bool) -> LSUNClass:
        return LSUNClass(
            self.lmdb_path,
            blacklist=CORRUPT_KEYS.get(self.category, ()),
            validate=validate,
        )

    def setup_train(self) -> None:
        if self.train_data is not None or self._stream_ds is not None:
            return
        if self.streaming is None:
            # cheap key count (B+tree entry count, no decode) decides mode
            with open_lmdb(self.lmdb_path) as reader:
                n_entries = len(reader)
            streaming = n_entries > self.streaming_threshold
        else:
            streaming = self.streaming

        if streaming:
            # no validation pass (it would decode every image up front);
            # corrupt values are resampled at batch time instead
            self._stream_ds = self._dataset(validate=False)
            n = len(self._stream_ds)
            self._stream_n = n if self.limit is None else min(self.limit, n)
            return

        ds = self._dataset(validate=True)
        n = len(ds) if self.limit is None else min(self.limit, len(ds))
        cache = os.path.join(
            self.data_dir, f"{self.category}_{self.split}_decoded_{self.imgsize}.npy"
        )
        if self.cache_decoded and os.path.exists(cache):
            data = np.load(cache, mmap_mode="r")
            if data.shape[0] >= n:
                self.train_data = data[:n]
                return
        self.train_data = self._decode_all(ds, n, cache if self.cache_decoded else None)

    def _decode_all(self, ds: LSUNClass, n: int, cache: Optional[str]):
        """Chunked parallel decode with bounded RSS: workers stream chunks,
        results land directly in an on-disk memmap (or RAM when no cache)."""
        if cache is not None:
            from numpy.lib.format import open_memmap

            out = open_memmap(
                cache, mode="w+", dtype=np.uint8,
                shape=(n, self.imgsize, self.imgsize, 3),
            )
        else:
            out = np.empty((n, self.imgsize, self.imgsize, 3), np.uint8)
        keys = ds.keys[:n]
        reader, size = ds.reader, self.imgsize
        with ThreadPoolExecutor(min(self.num_workers, max(1, n))) as pool:
            # chunked map keeps at most decode_chunk results in RAM
            for i0 in range(0, n, self.decode_chunk):
                chunk = keys[i0 : i0 + self.decode_chunk]
                for j, img in enumerate(
                    pool.map(lambda k: _decode_key(reader, k, size), chunk)
                ):
                    # validate=True already dropped undecodable keys
                    out[i0 + j] = img
        if cache is not None:
            out.flush()
            return np.load(cache, mmap_mode="r")
        return out

    def setup_test(self) -> None:
        self.setup_train()
        self.test_data = self.train_data

    # ------------------------------------------------------------- streaming
    def _stream_batches(
        self,
        order: Iterator[np.ndarray],
        pool: ThreadPoolExecutor,
        rng: np.random.Generator,
    ) -> Iterator[np.ndarray]:
        """Decode index-batches via the pool, one batch of prefetch ahead."""
        ds = self._stream_ds
        size = self.imgsize

        def submit(idx):
            return [
                pool.submit(_decode_key, ds.reader, ds.keys[i], size)
                for i in idx
            ]

        pending = None
        for idx in order:
            task = submit(idx)
            if pending is not None:
                yield self._finish(pending, rng)
            pending = task
        if pending is not None:
            yield self._finish(pending, rng)

    def _finish(self, futures, rng: np.random.Generator) -> np.ndarray:
        imgs = [f.result() for f in futures]
        # resample replacements for corrupt values (rare; keeps long runs up)
        ds = self._stream_ds
        for j, im in enumerate(imgs):
            while im is None:
                k = ds.keys[int(rng.integers(self._stream_n))]
                im = _decode_key(ds.reader, k, self.imgsize)
            imgs[j] = im
        return np.stack(imgs)

    def train_iter(
        self,
        seed: int = 0,
        *,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        skip_batches: int = 0,
    ):
        if self._stream_ds is None:
            yield from super().train_iter(
                seed,
                process_index=process_index,
                process_count=process_count,
                skip_batches=skip_batches,
            )
            return

        lo, hi = 0, self.batch_size
        if process_count is not None and process_count > 1:
            if self.batch_size % process_count:
                raise ValueError(f"global batch {self.batch_size} not divisible by "
                                 f"{process_count} processes")
            local = self.batch_size // process_count
            lo, hi = process_index * local, (process_index + 1) * local
        rng = np.random.default_rng(seed)
        # corrupt-value resampling draws from its OWN stream: pulling from
        # the permutation rng would desynchronize hosts the first time one
        # host's slice contains a corrupt image and another's doesn't
        resample_rng = np.random.default_rng((seed, 0xC0FFEE))
        n = self._stream_n

        def order():
            while True:
                perm = rng.permutation(n)
                for i in range(0, n - self.batch_size + 1, self.batch_size):
                    yield perm[i : i + self.batch_size][lo:hi]

        gen = order()
        for _ in range(skip_batches):  # resume: advance indices, no decode
            next(gen)
        with ThreadPoolExecutor(self.num_workers) as pool:
            yield from self._stream_batches(gen, pool, resample_rng)

    def test_iter(self):
        if self._stream_ds is None:
            yield from super().test_iter()
            return
        rng = np.random.default_rng(0)
        n = self._stream_n

        def order():
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                yield np.arange(i, i + self.batch_size)

        with ThreadPoolExecutor(self.num_workers) as pool:
            yield from self._stream_batches(order(), pool, rng)

    # ------------------------------------------------------------ device math
    def augment(self, generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
        if not self.horizontal_flip:
            return batch
        return random_horizontal_flip(generator, batch)
