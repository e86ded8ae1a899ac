"""InceptionV3 feature extractor for FID (pool3, 2048-d) and IS (logits)
(mirrors ``dmme_tpu/eval/inception.py``).

``variant="fid"`` is pytorch-fid's FID-standard network, the one behind
published FID numbers and the reference's torchmetrics metric: the
``pt_inception-2015-12-05`` weights on a modified torchvision topology, with
1008 logits, ``count_include_pad=False`` average pooling in the A and C
blocks and in Mixed_7b, and a max branch pool in Mixed_7c.
``variant="torchvision"`` is the stock 1000-class topology.

Inference only, NHWC at the interface: each Conv + BatchNorm pair is one
biased conv (``ConvBN.Conv_0``) with the BN folded in when the weights are
loaded (W′ = W·γ/√(σ²+ε), b′ = β − γμ/√(σ²+ε)). Module names are flax's, so
``utils.convert.from_flax`` loads the JAX package's tree unchanged.

The convolutions, pools and the fc are library operations, as they are XLA
operations in the JAX package. The feature function runs them in IEEE f32:
TF32 is off in its scope (:func:`ieee_f32`), whatever the caller set.

Weights are read from a local file, never downloaded: pytorch-fid's
``pt_inception-2015-12-05-6726825d.pth`` or torchvision's
``inception_v3_google-0cc3c7bd.pth`` (:func:`load_torch_weights`), or the
JAX package's ``.npz`` (:func:`load_npz`). Without one, the network is
randomly initialised from a seed: the FID and IS machinery runs, but its
values are not comparable with published numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dmme_tpu_torch.models.blocks import _lecun_normal_
from dmme_tpu_torch.utils.device import ieee_f32, resolve_device

BN_EPS = 1e-3
#: the side the network takes; :func:`preprocess` resizes to it
SIZE = 299


class ConvBN(nn.Module):
    """Conv with the BN folded in, then ReLU; padding as torch's conv."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Conv_0(x))


def _avg_pool_3x3_s1(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    # torchvision averages over the padded window; pytorch-fid's FID blocks
    # over the valid elements only (FIDInceptionA/C/E_1)
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = ConvBN(c_in, 64, 1)
        self.branch5x5_1 = ConvBN(c_in, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(c_in, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(c_in, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1(x, count_include_pad=not self.fid))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = ConvBN(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(c_in, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = ConvBN(c_in, 192, 1)
        self.branch7x7_1 = ConvBN(c_in, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(c_in, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(c_in, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1(x, count_include_pad=not self.fid))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(c_in, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(c_in, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    """``pool``: the branch pool, "avg" (torchvision), "avg_fid" (average
    over the valid elements: Mixed_7b of the FID network) or "max" (3×3
    stride 1: its Mixed_7c)."""

    def __init__(self, c_in: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = ConvBN(c_in, 320, 1)
        self.branch3x3_1 = ConvBN(c_in, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(c_in, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(c_in, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_s1(x, count_include_pad=self.pool == "avg")
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """NHWC images in [−1, 1] → (pool3 features (N, 2048), logits (N,
    num_classes)); ``num_classes`` defaults to 1008 for ``variant="fid"``,
    1000 for ``"torchvision"``."""

    def __init__(self, num_classes: Optional[int] = None, variant: str = "fid"):
        super().__init__()
        if variant not in ("fid", "torchvision"):
            raise ValueError(f"unknown InceptionV3 variant {variant!r} (fid|torchvision)")
        fid = variant == "fid"
        self.variant = variant
        self.num_classes = num_classes or (1008 if fid else 1000)
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid=fid)
        self.Mixed_5c = InceptionA(256, 64, fid=fid)
        self.Mixed_5d = InceptionA(288, 64, fid=fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid=fid)
        self.Mixed_6c = InceptionC(768, 160, fid=fid)
        self.Mixed_6d = InceptionC(768, 160, fid=fid)
        self.Mixed_6e = InceptionC(768, 192, fid=fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg_fid" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, pool="max" if fid else "avg")
        self.fc = nn.Linear(2048, self.num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # the NCHW view of an NHWC tensor is channels_last, which cuDNN keeps
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = _max_pool_3x3_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        feats = x.mean(dim=(2, 3))  # global average pool -> (N, 2048)
        return feats, self.fc(feats)


def init_random(model: InceptionV3, generator: torch.Generator) -> InceptionV3:
    """flax's default init, drawn from ``generator``: lecun-normal kernels
    and zero biases (the JAX package's network without a weights file)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
                m.bias.zero_()
    return model


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC of any size → 299×299, mapped to [−1, 1]. Bilinear with
    half-pixel centres, antialiased when it shrinks, as ``jax.image.resize``."""
    n, h, w, c = images.shape
    if (h, w) != (SIZE, SIZE):
        images = F.interpolate(images.permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
                               align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return images * 2.0 - 1.0


def load_torch_weights(model: InceptionV3, path: str) -> InceptionV3:
    """Load a torchvision or pytorch-fid ``inception_v3`` ``state_dict``
    file into ``model``: every ``<name>.conv`` + ``<name>.bn`` folded into
    ``<name>.Conv_0``, ``fc`` as it is, ``AuxLogits.*`` (torchvision's
    training head) dropped; strict on every parameter of ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    for key in sd:
        if not key.endswith(".conv.weight") or key.startswith("AuxLogits."):
            continue
        prefix = key[: -len(".conv.weight")]
        scale = sd[f"{prefix}.bn.weight"] / torch.sqrt(sd[f"{prefix}.bn.running_var"] + BN_EPS)
        out[f"{prefix}.Conv_0.weight"] = sd[key] * scale[:, None, None, None]
        out[f"{prefix}.Conv_0.bias"] = (sd[f"{prefix}.bn.bias"]
                                        - sd[f"{prefix}.bn.running_mean"] * scale)
    out["fc.weight"] = sd["fc.weight"]
    out["fc.bias"] = sd["fc.bias"]
    model.load_state_dict(out, strict=True)
    return model


def save_npz(model: InceptionV3, path: str) -> None:
    """The (folded) weights as the JAX package's ``.npz``: flat flax keys
    (``Mixed_5b/branch1x1/Conv_0/kernel``), HWIO conv kernels, (in, out)
    ``fc/kernel``."""
    flat = {}
    for key, v in model.state_dict().items():
        a = v.detach().cpu().numpy()
        path_, name = key.rsplit(".", 1)
        if name == "weight":
            name, a = "kernel", (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
        flat["/".join(path_.split(".") + [name])] = a
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's ``.npz`` → this module's ``state_dict``."""
    from dmme_tpu_torch.utils.convert import from_flax

    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return from_flax(tree)


def detect_variant(weights_path: str) -> Tuple[str, int]:
    """(variant, num_classes) from a weights file's fc: 1008 outputs is
    pytorch-fid's pt_inception-2015-12-05, anything else torchvision's."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as data:
            n_cls = int(data["fc/kernel"].shape[1])
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        n_cls = int(sd["fc.weight"].shape[0])
    return ("fid" if n_cls == 1008 else "torchvision"), n_cls


def make_feature_fn(weights_path: Optional[str] = None, num_classes: Optional[int] = None,
                    variant: str = "auto", device=None):
    """``feature_fn(images) -> (feats, logits)`` on [0, 1] NHWC images, on
    ``device`` (None: the CUDA device), under ``inference_mode`` and
    :func:`ieee_f32`.

    ``variant="auto"`` takes the variant from the weights file (a 1008-way
    fc is the FID-standard network), else the FID topology. Without
    ``weights_path`` the network is randomly initialised from seed 0."""
    device = resolve_device(device)
    if variant == "auto":
        if weights_path is not None:
            variant, n_cls = detect_variant(weights_path)
            num_classes = num_classes or n_cls
        else:
            variant = "fid"
    model = InceptionV3(num_classes=num_classes, variant=variant)
    if weights_path is None:
        init_random(model, torch.Generator().manual_seed(0))
    elif weights_path.endswith(".npz"):
        model.load_state_dict(load_npz(weights_path), strict=True)
    else:
        load_torch_weights(model, weights_path)
    model = model.to(device).eval()

    def feature_fn(images):
        with torch.inference_mode(), ieee_f32():
            x = torch.as_tensor(images, dtype=torch.float32, device=device)
            return model(preprocess(x))

    return feature_fn
