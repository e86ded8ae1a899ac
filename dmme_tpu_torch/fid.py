"""The standalone FID tool (mirrors ``scripts/fid.py``):

    python -m dmme_tpu_torch.fid PATH1 PATH2 [--weights w.pth] [--batch-size 64]
    python -m dmme_tpu_torch.fid PATH --save-stats stats.npz [--weights w.pth]

Each PATH is a directory of images (png, jpg, jpeg, bmp, webp), a ``.npy``
array of images ((N, H, W, C) float in [0, 1] or uint8, e.g. the output of
``dmme_tpu_torch.trainer predict``), or precomputed statistics in
pytorch-fid's ``.npz`` (keys ``mu`` and ``sigma``). Prints ``FID: <value>``.
With pytorch-fid's ``pt_inception-2015-12-05`` weights the value is
comparable with published numbers; without ``--weights`` the Inception is
random and the values are only consistent with each other.

Runs on the CUDA device; ``main(argv, device="cpu")`` is the tests' way onto
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _iter_batches(path: str, batch_size: int):
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim != 4:
            raise ValueError(f"want (N,H,W,C), got {arr.shape}")
        for i in range(0, len(arr), batch_size):
            yield arr[i: i + batch_size]
        return

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading the image directory {path} needs PIL (Pillow), which is "
                          "not installed; pass a .npy array of the images instead") from e
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(IMG_EXTS))
    if not files:
        raise ValueError(f"no images under {path}")
    batch = []
    size = None
    for f in files:
        with Image.open(f) as opened:
            im = opened.convert("RGB")
        if size is None:
            size = im.size
        elif im.size != size:  # mixed sizes: the first image's
            im = im.resize(size, Image.BILINEAR)
        batch.append(np.asarray(im, np.float32) / 255.0)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def _stats_for(path: str, feature_fn, batch_size: int):
    """(mu, sigma) of a path of any kind."""
    from dmme_tpu_torch.eval.fid import FeatureStats

    if path.endswith(".npz"):
        d = np.load(path)
        return np.asarray(d["mu"], np.float64), np.asarray(d["sigma"], np.float64)
    stats = None
    for batch in _iter_batches(path, batch_size):
        feats, _ = feature_fn(batch)
        if stats is None:
            stats = FeatureStats.create(feats.shape[-1], device=feats.device)
        stats = stats.update(feats)
    return stats.moments()


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(prog="dmme_tpu_torch.fid", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="two paths (FID) or one with --save-stats")
    ap.add_argument("--weights", default=None,
                    help="InceptionV3 weights (pytorch-fid .pth or the JAX package's .npz)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--save-stats", default=None,
                    help="compute (mu, sigma) of a single path into this .npz")
    args = ap.parse_args(argv)

    from dmme_tpu_torch.eval.fid import frechet_distance
    from dmme_tpu_torch.eval.inception import make_feature_fn

    need_net = not all(p.endswith(".npz") for p in args.paths)
    feature_fn = make_feature_fn(args.weights, device=device) if need_net else None
    if args.weights is None and need_net:
        print("# WARNING: no --weights — random Inception; values are NOT "
              "comparable to published FID numbers", file=sys.stderr)

    if args.save_stats:
        if len(args.paths) != 1:
            ap.error("--save-stats takes exactly one path")
        mu, sigma = _stats_for(args.paths[0], feature_fn, args.batch_size)
        np.savez(args.save_stats, mu=mu, sigma=sigma)
        print(args.save_stats)
        return

    if len(args.paths) != 2:
        ap.error("need exactly two paths for FID")
    mu1, s1 = _stats_for(args.paths[0], feature_fn, args.batch_size)
    mu2, s2 = _stats_for(args.paths[1], feature_fn, args.batch_size)
    fid = frechet_distance(mu1, s1, mu2, s2)
    if -1e-6 < fid < 0.0:
        fid = 0.0  # roundoff of the eigendecomposition's trace
    print(f"FID: {fid:.6f}")


if __name__ == "__main__":
    main()
