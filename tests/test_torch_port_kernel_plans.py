"""Launch geometry of the port's CUDA kernels, planned in Python and checked
on the CPU at every call site of the main path: K3 (attention) at serving
batches 1, 8 and 16 and at training batch 128, K4 (fused ResBlock) at
serving batches 1, 8 and 16; at the LSUN widths of
``configs/ddpm/lsun_*.yaml`` (channels 128/128/256/256/512/512, attention at
depth 5, 256×256 inputs) at batch 1 and 2; and on latent diffusion's 16×16×4
latents (the latent harness's default UNet, the UNet of
``configs/latent/shapes_latent_demo.yaml`` and the DiT of
``shapes_latent_flow_dit_demo.yaml``). The call sites come from a
full-width bf16 UNet forward on PyTorch's meta device (shapes only, no
data), with the kernel entry points replaced by recorders. The card is an
H100 SXM: 132 SMs.
"""

import functools
import math

import pytest
import torch

import dmme_tpu_torch.models.blocks as blocks
from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models import iddpm as iddpm_models
from dmme_tpu_torch.models import unet as unet_models
from dmme_tpu_torch.ops import SMEM_MAX
from dmme_tpu_torch.ops import attention as t_attention
from dmme_tpu_torch.ops import resblock as t_resblock

SMS = 132
SERVE_BATCHES = (1, 8, 16)
TRAIN_BATCH = 128
LSUN_BATCHES = (1, 2)
# (UNet, widths, image size) of the configs the port runs: the DDPM UNet of
# configs/ddpm/{cifar10,lsun_*}.yaml and the IDDPM UNet (FiLM, 4 heads) of
# configs/iddpm/{cifar10,shapes64_demo}.yaml
WIDTHS = {
    "cifar10": (ddpm_models.UNet, {}, 32),
    "lsun": (ddpm_models.UNet,
             dict(channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,)), 256),
    "iddpm": (iddpm_models.UNet, {}, 32),
    "iddpm64": (iddpm_models.UNet, dict(channels_per_depth=(128, 256, 384, 512), num_blocks=3,
                                        attention_depths=(3, 4), dropout=0.0), 64),
    # latent diffusion on 16x16x4 latents: the latent harness's default UNet
    # and the UNet of configs/latent/shapes_latent_demo.yaml (K3 only there)
    "latent": (ddpm_models.UNet, dict(in_channels=4), 16),
    "latent_cfg": (unet_models.UNet, dict(in_channels=4, channels_per_depth=(128, 256, 256),
                                          attention_depths=(2,)), 16),
}


@functools.lru_cache(maxsize=None)
def call_sites(n: int, widths: str = "cifar10") -> dict:
    """{"attention": [q shape], "resblock": [(x shape, C_out,
    projection?)]}, one entry per call of a full-width UNet forward at batch
    n, at the widths and image size of ``WIDTHS[widths]``."""
    unet, kwargs, img = WIDTHS[widths]
    seen = {"attention": [], "resblock": []}

    def attention(q, k, v, scale):
        seen["attention"].append(tuple(q.shape))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def resblock(x, *args, wr=None, br=None, num_groups=32, eps=None):
        cout = args[5].shape[0]
        seen["resblock"].append((tuple(x.shape), cout, wr is not None))
        return torch.empty((*x.shape[:3], cout), dtype=x.dtype, device=x.device)

    def gn_silu(x, gamma, beta, groups, eps=None, pre_bias=None):
        return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)

    patched = {"attention_heads": attention, "resblock_forward": resblock,
               "group_norm_silu": gn_silu}
    saved = {k: getattr(blocks, k) for k in patched}
    try:
        for k, fn in patched.items():
            setattr(blocks, k, fn)
        with torch.device("meta"), torch.no_grad():
            model = unet(dtype=torch.bfloat16, fused_norm=True, fused_block=True, **kwargs)
            model.eval()
            model(torch.empty((n, img, img, kwargs.get("in_channels", 3))),
                  torch.zeros((n,), dtype=torch.int64))
    finally:
        for k, fn in saved.items():
            setattr(blocks, k, fn)
    return seen


def test_call_sites_per_forward():
    """6 attention and 22 ResBlock calls per forward, as chip_smoke counts
    them; 3 and 11 distinct shapes."""
    sites = call_sites(8)
    assert len(sites["attention"]) == 6 and len(sites["resblock"]) == 22
    assert len(set(sites["attention"])) == 3 and len(set(sites["resblock"])) == 11


def _attention_shapes():
    for n in SERVE_BATCHES + (TRAIN_BATCH,):
        for shape in sorted(set(call_sites(n)["attention"])):
            yield n, shape


@pytest.mark.parametrize("n,shape", list(_attention_shapes()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_attention_plan_covers_every_key_tile_once(n, shape):
    _check_attention_plan(n, shape)


def _check_attention_plan(n, shape):
    _, t, h, d = shape
    plan = t_attention.attention_plan(n, h, t, d, SMS)
    assert plan.dp == -(-d // 64) * 64 and plan.halves == (2 if d == 512 else 1)
    assert plan.bq in t_attention.BLOCK_QUERIES[plan.dp]
    assert plan.bkv == (32 if plan.dp > 128 else 64)
    if plan.bq == 128:  # two warpgroups only where such blocks alone fill the SMs
        assert plan.q_tiles * n * h >= SMS
    tiles = [j for r in plan.split_tiles() for j in r]
    assert tiles == list(range(plan.kv_tiles))
    assert all(len(r) > 0 for r in plan.split_tiles())
    assert (plan.kv_tiles - 1) * plan.bkv < t <= plan.kv_tiles * plan.bkv
    assert (plan.q_tiles - 1) * plan.bq < t <= plan.q_tiles * plan.bq
    blocks_ = plan.q_tiles * n * h * plan.halves
    if plan.halves > 1 or 8 * blocks_ > SMS or t * plan.dp < t_attention.SPLIT_MIN_WORK:
        assert plan.splits == 1
    else:  # split, two key tiles at least a split, up to about one block per SM
        assert 1 < plan.splits <= min(plan.kv_tiles // 2, math.ceil(SMS / blocks_))
        assert plan.kv_per_split >= 2
    # the strided views of a packed (N, T, 3, H, D) projection are read in
    # place by 16-byte copies
    qkv = torch.empty((n, t, 3, h, d), dtype=torch.bfloat16, device="meta")
    for i in range(3):
        view = qkv[:, :, i]
        assert t_attention._aligned(view)
        assert all(s * 2 % 16 == 0 for s in view.stride()[:3]) and view.stride(3) == 1


def test_attention_plan_splits_and_head_dims():
    train = t_attention.attention_plan(128, 1, 256, 128, SMS)
    assert (train.bq, train.q_tiles, train.kv_tiles, train.splits) == (128, 2, 4, 1)
    assert t_attention.attention_plan(128, 1, 256, 256, SMS).bq == 64
    assert t_attention.attention_plan(8, 1, 256, 128, SMS).bq == 64
    # batch 1 at 256 x 256: 4 blocks, 8 key tiles of 32, split in 4
    plan = t_attention.attention_plan(1, 1, 256, 256, SMS)
    assert (plan.q_tiles, plan.kv_tiles, plan.splits) == (4, 8, 4)
    assert [list(r) for r in plan.split_tiles()] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # at 256 x 128 the key loop is too short to pay for the merge
    assert t_attention.attention_plan(1, 1, 256, 128, SMS).splits == 1
    assert t_attention.attention_plan(16, 1, 256, 256, SMS).splits == 1
    # a longer key loop at batch 1: 9 splits asked, rounded to 8 of 4 tiles, none empty
    plan = t_attention.attention_plan(1, 1, 1024, 256, SMS)
    assert (plan.q_tiles, plan.kv_tiles, plan.splits, plan.kv_per_split) == (16, 32, 8, 4)
    assert [len(r) for r in plan.split_tiles()] == [4] * 8
    # as many splits as leave two key tiles each
    plan = t_attention.attention_plan(2, 1, 320, 256, SMS)
    assert (plan.kv_tiles, plan.kv_per_split, plan.splits) == (10, 2, 5)
    assert [len(r) for r in plan.split_tiles()] == [2] * 5
    # made once per shape: the launcher's repeated calls do no planning
    assert t_attention.attention_plan(8, 1, 256, 256, SMS) is t_attention.attention_plan(
        8, 1, 256, 256, SMS)
    for d in (40, 320):
        with pytest.raises(ValueError, match="head dims"):
            t_attention.attention_plan(1, 1, 16, d, SMS)
    # head dims off the 64-wide panels run the next kernel, padded; 512 in halves
    assert t_attention.attention_plan(8, 4, 256, 96, SMS).dp == 128
    assert t_attention.attention_plan(8, 4, 256, 160, SMS)[-2:] == (192, 1)
    plan = t_attention.attention_plan(1, 1, 64, 512, SMS)
    assert (plan.dp, plan.halves, plan.bq, plan.bkv, plan.splits) == (512, 2, 64, 32, 1)
    assert t_attention.attention_plan(1, 1, 1024, 512, SMS).splits == 1


def _resblock_shapes():
    for n in SERVE_BATCHES:
        for shape, cout, proj in sorted(set(call_sites(n)["resblock"])):
            yield n, shape, cout, proj


@pytest.mark.parametrize("n,shape,cout,proj", list(_resblock_shapes()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_resblock_plan_boxes_and_k_steps(n, shape, cout, proj):
    _check_resblock_plan(n, shape, cout, proj)


def _check_resblock_plan(n, shape, cout, proj):
    _, h, w, cin = shape
    p1 = t_resblock.conv_plan(n, h, w, cin, cout, 0, SMS)
    p2 = t_resblock.conv_plan(n, h, w, cout, cout, cin if proj else 0, SMS)
    m = n * h * w
    for plan, c_conv, c_proj in ((p1, cin, 0), (p2, cout, cin if proj else 0)):
        # every K step exactly once: 9 taps x 64-channel chunks, then the projection
        assert plan.steps * t_resblock.BK == 9 * c_conv + c_proj
        steps = [s for r in plan.slices() for s in r]
        assert steps == list(range(plan.steps))
        assert all(len(r) > 0 for r in plan.slices())
        assert plan.splits == 1 or plan.per >= t_resblock.MIN_STEPS
        # one TMA box of (64, w, h, n) is one tile of bm pixels in raster order
        nb, hb, wb = plan.box
        assert nb * hb * wb == plan.bm and max(t_resblock.BK, nb, hb, wb) <= 256
        assert (nb == 1 or (hb == h and wb == w)) and (hb == 1 or wb == w)
        assert h % hb == 0 and w % wb == 0
        assert (plan.m_tiles - 1) * plan.bm < m <= plan.m_tiles * plan.bm
        assert plan.n_tiles * t_resblock.BN == cout
        # TMA's global strides, in bytes: the NHWC operands and the packed weights
        for c in (c_conv, cin):
            assert all(s % 16 == 0 for s in (2 * c, 2 * w * c, 2 * h * w * c))
        assert 2 * (9 * c_conv + c_proj) % 16 == 0
        assert plan.bm == (128 if 4 * -(-m // 128) * plan.n_tiles >= SMS else 64)
        if plan.m_tiles * plan.n_tiles >= SMS:
            assert plan.splits == 1
        else:
            assert plan.splits * plan.m_tiles * plan.n_tiles <= max(SMS, plan.m_tiles * plan.n_tiles)
    assert p1.bm == p2.bm  # one tile for both convs of a call


def test_resblock_plan_tile_choice_and_errors():
    # 128-pixel tiles where they alone make blocks for a quarter of the SMs
    plan = t_resblock.conv_plan(8, 32, 32, 128, 128, 0, SMS)
    assert plan.bm == 128 and plan.box == (1, 4, 32) and plan.m_tiles == 64
    assert plan.splits == 2 and plan.per == 9
    assert t_resblock.conv_plan(8, 16, 16, 128, 256, 0, SMS).bm == 64
    assert t_resblock.conv_plan(1, 32, 32, 128, 128, 0, SMS).bm == 64
    plan = t_resblock.conv_plan(16, 16, 16, 128, 256, 0, SMS)
    assert plan.bm == 128 and plan.box == (1, 8, 16) and plan.m_tiles == 32 and plan.splits == 2
    # batch 1 at 4 x 4: one 64-pixel tile of four images, three of them past N
    plan = t_resblock.conv_plan(1, 4, 4, 512, 256, 0, SMS)
    assert (plan.bm, plan.box, plan.m_tiles, plan.n_tiles) == (64, (4, 4, 4), 1, 2)
    assert t_resblock.conv_plan(1, 4, 4, 512, 256, 0, SMS) is plan  # made once per shape
    assert t_resblock.pixel_box(4, 4, 128) == (8, 4, 4)
    assert t_resblock.pixel_box(8, 8, 128) == (2, 8, 8)
    assert t_resblock.pixel_box(16, 16, 128) == (1, 8, 16)
    assert t_resblock.pixel_box(4, 256, 128) == (1, 1, 128)
    # H x W that whole rows or images do not tile: spatial boxes reaching past the image
    for (h, w), box in {(6, 6): (1, 8, 8), (12, 8): (1, 8, 8), (3, 16): (1, 4, 16),
                        (5, 100): (1, 1, 64)}.items():
        assert t_resblock.pixel_box(h, w, 64) == box
    plan = t_resblock.conv_plan(1, 6, 6, 128, 128, 0, SMS)
    assert (plan.box, plan.m_tiles) == ((1, 8, 8), 1)
    for c_in, c_out in ((20, 128), (128, 100)):
        with pytest.raises(ValueError, match="multiples of 8"):
            t_resblock.conv_plan(1, 8, 8, c_in, c_out, 0, SMS)


# The input domains of the CUDA kernels: head dims that are multiples of 16
# up to 256, and 512; C_in and C_out that are multiples of 8 and any H x W.
# Outside them the kernel raises on the card. The CPU takes the plain
# versions, which accept any shape.
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 128, 160, 192, 256, 320,
                               8, 40, 208, 240, 384, 512])
def test_attention_kernel_head_dims(d):
    if d % 16 == 0 and (d <= 256 or d == 512):
        plan = t_attention.attention_plan(8, 4, 256, d, SMS)
        assert plan.bkv in (32, 64) and plan.dp - 64 < d <= plan.dp
        assert plan.dp in t_attention.BLOCK_QUERIES
    else:
        with pytest.raises(ValueError, match="head dims"):
            t_attention.attention_plan(8, 4, 256, d, SMS)


@pytest.mark.parametrize("c_in,c_out", [(64, 128), (128, 128), (192, 384), (384, 768),
                                        (32, 128), (96, 128), (128, 64), (192, 192),
                                        (128, 320), (32, 32), (96, 192), (20, 128),
                                        (128, 100)])
def test_resblock_kernel_channels(c_in, c_out):
    if c_in % 8 == 0 and c_out % 8 == 0:
        for c_proj in (0, c_in):
            plan = t_resblock.conv_plan(8, 8, 8, c_in, c_out, c_proj, SMS)
            assert (plan.n_tiles - 1) * t_resblock.BN < c_out <= plan.n_tiles * t_resblock.BN
            # every K step once: 9 taps of 64-channel chunks, the last partial, then the projection
            assert plan.steps == 9 * -(-c_in // 64) + -(-c_proj // 64)
            assert [s for r in plan.slices() for s in r] == list(range(plan.steps))
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            t_resblock.conv_plan(8, 8, 8, c_in, c_out, 0, SMS)


@pytest.mark.parametrize("n,h,w", [(1, 6, 6), (2, 12, 8), (3, 3, 16), (1, 5, 100), (2, 7, 9),
                                   (8, 32, 32), (1, 4, 4)])
def test_resblock_tiles_store_every_pixel_once(n, h, w):
    """The M tiles of any H x W store every output pixel exactly once."""
    for c_out in (64, 128):
        plan = t_resblock.conv_plan(n, h, w, 96, c_out, 0, SMS)
        stored = [m for t in range(plan.m_tiles)
                  for m in t_resblock.tile_pixels(n, h, w, plan.box, t)]
        assert sorted(stored) == list(range(n * h * w))
        assert plan.box[0] * plan.box[1] * plan.box[2] == plan.bm
        assert max(plan.box) <= 256


# The main path's plans before the domain was widened: widening it changes none
# (key: (N, T, H, D) -> (bq, bkv, q_tiles, kv_tiles, splits, kv_per_split);
# (N, H, W, C_conv, C_out, C_proj) -> (bm, box, m_tiles, n_tiles, steps,
# splits, per)).
MAIN_ATTENTION = {
    (1, 16, 1, 256): (64, 32, 1, 1, 1, 1), (1, 256, 1, 128): (64, 64, 4, 4, 1, 4),
    (1, 256, 1, 256): (64, 32, 4, 8, 4, 2), (8, 16, 1, 256): (64, 32, 1, 1, 1, 1),
    (8, 256, 1, 128): (64, 64, 4, 4, 1, 4), (8, 256, 1, 256): (64, 32, 4, 8, 1, 8),
    (16, 16, 1, 256): (64, 32, 1, 1, 1, 1), (16, 256, 1, 128): (64, 64, 4, 4, 1, 4),
    (16, 256, 1, 256): (64, 32, 4, 8, 1, 8), (128, 16, 1, 256): (64, 32, 1, 1, 1, 1),
    (128, 256, 1, 128): (128, 64, 2, 4, 1, 4), (128, 256, 1, 256): (64, 32, 4, 8, 1, 8),
}
MAIN_CONV = {
    (1, 16, 16, 128, 128, 256): (64, (1, 4, 16), 4, 1, 22, 5, 5),
    (1, 16, 16, 128, 128, 512): (64, (1, 4, 16), 4, 1, 26, 6, 5),
    (1, 16, 16, 128, 256, 0): (64, (1, 4, 16), 4, 2, 18, 4, 5),
    (1, 16, 16, 256, 128, 0): (64, (1, 4, 16), 4, 1, 36, 9, 4),
    (1, 16, 16, 256, 256, 0): (64, (1, 4, 16), 4, 2, 36, 9, 4),
    (1, 16, 16, 256, 256, 128): (64, (1, 4, 16), 4, 2, 38, 8, 5),
    (1, 16, 16, 256, 256, 512): (64, (1, 4, 16), 4, 2, 44, 11, 4),
    (1, 16, 16, 512, 128, 0): (64, (1, 4, 16), 4, 1, 72, 18, 4),
    (1, 16, 16, 512, 256, 0): (64, (1, 4, 16), 4, 2, 72, 15, 5),
    (1, 32, 32, 128, 128, 0): (64, (1, 2, 32), 16, 1, 18, 4, 5),
    (1, 32, 32, 128, 128, 256): (64, (1, 2, 32), 16, 1, 22, 5, 5),
    (1, 32, 32, 256, 128, 0): (64, (1, 2, 32), 16, 1, 36, 8, 5),
    (1, 4, 4, 256, 256, 0): (64, (4, 4, 4), 1, 2, 36, 9, 4),
    (1, 4, 4, 256, 256, 512): (64, (4, 4, 4), 1, 2, 44, 11, 4),
    (1, 4, 4, 512, 256, 0): (64, (4, 4, 4), 1, 2, 72, 18, 4),
    (1, 8, 8, 256, 256, 0): (64, (1, 8, 8), 1, 2, 36, 9, 4),
    (1, 8, 8, 256, 256, 512): (64, (1, 8, 8), 1, 2, 44, 11, 4),
    (1, 8, 8, 512, 256, 0): (64, (1, 8, 8), 1, 2, 72, 18, 4),
    (16, 16, 16, 128, 128, 256): (64, (1, 4, 16), 64, 1, 22, 2, 11),
    (16, 16, 16, 128, 128, 512): (64, (1, 4, 16), 64, 1, 26, 2, 13),
    (16, 16, 16, 128, 256, 0): (128, (1, 8, 16), 32, 2, 18, 2, 9),
    (16, 16, 16, 256, 128, 0): (64, (1, 4, 16), 64, 1, 36, 2, 18),
    (16, 16, 16, 256, 256, 0): (128, (1, 8, 16), 32, 2, 36, 2, 18),
    (16, 16, 16, 256, 256, 128): (128, (1, 8, 16), 32, 2, 38, 2, 19),
    (16, 16, 16, 256, 256, 512): (128, (1, 8, 16), 32, 2, 44, 2, 22),
    (16, 16, 16, 512, 128, 0): (64, (1, 4, 16), 64, 1, 72, 2, 36),
    (16, 16, 16, 512, 256, 0): (128, (1, 8, 16), 32, 2, 72, 2, 36),
    (16, 32, 32, 128, 128, 0): (128, (1, 4, 32), 128, 1, 18, 1, 18),
    (16, 32, 32, 128, 128, 256): (128, (1, 4, 32), 128, 1, 22, 1, 22),
    (16, 32, 32, 256, 128, 0): (128, (1, 4, 32), 128, 1, 36, 1, 36),
    (16, 4, 4, 256, 256, 0): (64, (4, 4, 4), 4, 2, 36, 9, 4),
    (16, 4, 4, 256, 256, 512): (64, (4, 4, 4), 4, 2, 44, 11, 4),
    (16, 4, 4, 512, 256, 0): (64, (4, 4, 4), 4, 2, 72, 15, 5),
    (16, 8, 8, 256, 256, 0): (64, (1, 8, 8), 16, 2, 36, 4, 9),
    (16, 8, 8, 256, 256, 512): (64, (1, 8, 8), 16, 2, 44, 4, 11),
    (16, 8, 8, 512, 256, 0): (64, (1, 8, 8), 16, 2, 72, 4, 18),
    (8, 16, 16, 128, 128, 256): (64, (1, 4, 16), 32, 1, 22, 4, 6),
    (8, 16, 16, 128, 128, 512): (64, (1, 4, 16), 32, 1, 26, 4, 7),
    (8, 16, 16, 128, 256, 0): (64, (1, 4, 16), 32, 2, 18, 2, 9),
    (8, 16, 16, 256, 128, 0): (64, (1, 4, 16), 32, 1, 36, 4, 9),
    (8, 16, 16, 256, 256, 0): (64, (1, 4, 16), 32, 2, 36, 2, 18),
    (8, 16, 16, 256, 256, 128): (64, (1, 4, 16), 32, 2, 38, 2, 19),
    (8, 16, 16, 256, 256, 512): (64, (1, 4, 16), 32, 2, 44, 2, 22),
    (8, 16, 16, 512, 128, 0): (64, (1, 4, 16), 32, 1, 72, 4, 18),
    (8, 16, 16, 512, 256, 0): (64, (1, 4, 16), 32, 2, 72, 2, 36),
    (8, 32, 32, 128, 128, 0): (128, (1, 4, 32), 64, 1, 18, 2, 9),
    (8, 32, 32, 128, 128, 256): (128, (1, 4, 32), 64, 1, 22, 2, 11),
    (8, 32, 32, 256, 128, 0): (128, (1, 4, 32), 64, 1, 36, 2, 18),
    (8, 4, 4, 256, 256, 0): (64, (4, 4, 4), 2, 2, 36, 9, 4),
    (8, 4, 4, 256, 256, 512): (64, (4, 4, 4), 2, 2, 44, 11, 4),
    (8, 4, 4, 512, 256, 0): (64, (4, 4, 4), 2, 2, 72, 18, 4),
    (8, 8, 8, 256, 256, 0): (64, (1, 8, 8), 8, 2, 36, 8, 5),
    (8, 8, 8, 256, 256, 512): (64, (1, 8, 8), 8, 2, 44, 8, 6),
    (8, 8, 8, 512, 256, 0): (64, (1, 8, 8), 8, 2, 72, 8, 9),
}


def test_main_path_plans_are_unchanged():
    """Every K3 and K4 plan of the main path equals the pinned one."""
    seen_attn, seen_conv = {}, {}
    for n in SERVE_BATCHES + (TRAIN_BATCH,):
        for nn, t, h, d in set(call_sites(n)["attention"]):
            seen_attn[(nn, t, h, d)] = tuple(t_attention.attention_plan(nn, h, t, d, SMS))[:6]
    for n in SERVE_BATCHES:
        for (nn, h, w, cin), cout, proj in set(call_sites(n)["resblock"]):
            for c_conv, c_proj in ((cin, 0), (cout, cin if proj else 0)):
                p = t_resblock.conv_plan(nn, h, w, c_conv, cout, c_proj, SMS)
                seen_conv[(nn, h, w, c_conv, cout, c_proj)] = (p.bm, p.box, p.m_tiles, p.n_tiles,
                                                               p.steps, p.splits, p.per)
    assert seen_attn == MAIN_ATTENTION
    assert seen_conv == MAIN_CONV


def test_lsun_call_sites_per_forward():
    """The LSUN widths: 6 attention calls (16x16 tokens of 512 and of 256
    channels, 8x8 of 512: one head, so head dims 512 and 256) and 32
    ResBlocks from 256x256 down to 8x8."""
    sites = call_sites(1, "lsun")
    assert len(sites["attention"]) == 6 and len(sites["resblock"]) == 32
    assert set(sites["attention"]) == {(1, 256, 1, 512), (1, 256, 1, 256), (1, 64, 1, 512)}
    assert {s[0][1] for s in sites["resblock"]} == {256, 128, 64, 32, 16, 8}


def _lsun_attention():
    for n in LSUN_BATCHES:
        for shape in sorted(set(call_sites(n, "lsun")["attention"])):
            yield n, shape


def _lsun_resblock():
    for n in LSUN_BATCHES:
        for shape, cout, proj in sorted(set(call_sites(n, "lsun")["resblock"])):
            yield n, shape, cout, proj


@pytest.mark.parametrize("n,shape", list(_lsun_attention()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_lsun_attention_plan_covers_every_key_tile_once(n, shape):
    _check_attention_plan(n, shape)


@pytest.mark.parametrize("n,shape,cout,proj", list(_lsun_resblock()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_lsun_resblock_plan_boxes_and_k_steps(n, shape, cout, proj):
    _check_resblock_plan(n, shape, cout, proj)


# The IDDPM UNet (FiLM, 4 heads): K3's plans at the 11 call sites of
# configs/iddpm/cifar10.yaml (serving batches 1, 8, 16; training batch 128)
# and the 15 of configs/iddpm/shapes64_demo.yaml (a grid of 8; training batch
# 64), pinned as MAIN_ATTENTION pins the DDPM path's.
IDDPM_ATTENTION = {
    (n, t, 4, d): plan
    for n in SERVE_BATCHES + (TRAIN_BATCH,)
    for (t, d), plan in {(16, 64): (64, 64, 1, 1, 1, 1), (64, 64): (64, 64, 1, 1, 1, 1),
                         (256, 32): (64, 64, 4, 4, 1, 4),
                         (256, 64): (64, 64, 4, 4, 1, 4)}.items()
}
SHAPES64_BATCHES = (8, 64)
SHAPES64_ATTENTION = {
    (8, 64, 4, 96): (64, 64, 1, 1, 1, 1), (8, 64, 4, 128): (64, 64, 1, 1, 1, 1),
    (8, 256, 4, 64): (64, 64, 4, 4, 1, 4), (8, 256, 4, 96): (64, 64, 4, 4, 1, 4),
    (64, 64, 4, 96): (128, 64, 1, 1, 1, 1), (64, 64, 4, 128): (128, 64, 1, 1, 1, 1),
    (64, 256, 4, 64): (64, 64, 4, 4, 1, 4), (64, 256, 4, 96): (128, 64, 2, 4, 1, 4),
}


def test_iddpm_call_sites_per_forward():
    """configs/iddpm/cifar10.yaml: 11 four-head attention calls (T = 256 with
    D = 64 three times and D = 32 twice, T = 64 with D = 64 five times, T = 16
    once) and the DDPM path's 22 ResBlock shapes, whose K4 plans are pinned in
    MAIN_CONV; shapes64_demo: 15 attention calls, D 64, 96 and 128."""
    sites = call_sites(8, "iddpm")
    counts = {}
    for shape in sites["attention"]:
        counts[shape] = counts.get(shape, 0) + 1
    assert counts == {(8, 256, 4, 64): 3, (8, 256, 4, 32): 2, (8, 64, 4, 64): 5,
                      (8, 16, 4, 64): 1}
    assert sites["resblock"] == call_sites(8)["resblock"]
    big = call_sites(8, "iddpm64")
    assert len(big["attention"]) == 15 and len(big["resblock"]) == 30
    assert {s[3] for s in big["attention"]} == {64, 96, 128}


def _iddpm_attention():
    for widths, batches in (("iddpm", SERVE_BATCHES + (TRAIN_BATCH,)),
                            ("iddpm64", SHAPES64_BATCHES)):
        for n in batches:
            for shape in sorted(set(call_sites(n, widths)["attention"])):
                yield widths, n, shape


@pytest.mark.parametrize("widths,n,shape", list(_iddpm_attention()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_iddpm_attention_plan_covers_every_key_tile_once(widths, n, shape):
    _check_attention_plan(n, shape)


def test_iddpm_attention_plans_are_pinned():
    for widths, batches, pinned in (("iddpm", SERVE_BATCHES + (TRAIN_BATCH,), IDDPM_ATTENTION),
                                    ("iddpm64", SHAPES64_BATCHES, SHAPES64_ATTENTION)):
        seen = {}
        for n in batches:
            for nn, t, h, d in set(call_sites(n, widths)["attention"]):
                seen[(nn, t, h, d)] = tuple(t_attention.attention_plan(nn, h, t, d, SMS))[:6]
        assert seen == pinned, widths


# Latent diffusion on 16x16x4 latents. The default latent UNet (both
# switches) reaches K1/K4 at 2x2 (its bottom, 2x2x256) and K3 at T = 4
# (its middle attention; 4 keys of one 32-key tile), T = 64 with D = 256 and
# D = 128; the stage-2 config's UNet (128/256/256, no switches) K3 at T = 64
# and 16; the DiT of shapes_latent_flow_dit_demo.yaml (hidden 256, patch 2)
# K3 with 4 heads of 64 at T = 64. K3's plans depend on (T, H, D) alone at
# these batches; K4's at the serving batches are pinned as MAIN_CONV pins
# the pixel path's.
LATENT_ATTENTION = {(64, 1, 128): (64, 64, 1, 1, 1, 1), (4, 1, 256): (64, 32, 1, 1, 1, 1),
                    (64, 1, 256): (64, 32, 1, 2, 1, 2), (16, 1, 256): (64, 32, 1, 1, 1, 1),
                    (64, 4, 64): (64, 64, 1, 1, 1, 1)}
LATENT_CONV = {
    (n, 2, 2, c, 256, proj): (64, (16, 2, 2), 1, 2, steps, splits, per)
    for n in SERVE_BATCHES
    for c, proj, steps, splits, per in ((256, 0, 36, 9, 4), (256, 512, 44, 11, 4),
                                        (512, 0, 72, 18, 4))
}
LATENT_CONV.update({
    (1, 4, 4, 256, 256, 0): (64, (4, 4, 4), 1, 2, 36, 9, 4),
    (1, 4, 4, 256, 256, 512): (64, (4, 4, 4), 1, 2, 44, 11, 4),
    (1, 4, 4, 512, 256, 0): (64, (4, 4, 4), 1, 2, 72, 18, 4),
    (1, 8, 8, 128, 128, 256): (64, (1, 8, 8), 1, 1, 22, 5, 5),
    (1, 8, 8, 128, 128, 512): (64, (1, 8, 8), 1, 1, 26, 6, 5),
    (1, 8, 8, 128, 256, 0): (64, (1, 8, 8), 1, 2, 18, 4, 5),
    (1, 8, 8, 256, 128, 0): (64, (1, 8, 8), 1, 1, 36, 9, 4),
    (1, 8, 8, 256, 256, 0): (64, (1, 8, 8), 1, 2, 36, 9, 4),
    (1, 8, 8, 256, 256, 128): (64, (1, 8, 8), 1, 2, 38, 8, 5),
    (1, 8, 8, 256, 256, 512): (64, (1, 8, 8), 1, 2, 44, 11, 4),
    (1, 8, 8, 512, 128, 0): (64, (1, 8, 8), 1, 1, 72, 18, 4),
    (1, 8, 8, 512, 256, 0): (64, (1, 8, 8), 1, 2, 72, 18, 4),
    (1, 16, 16, 128, 128, 0): (64, (1, 4, 16), 4, 1, 18, 4, 5),
    (1, 16, 16, 128, 128, 256): (64, (1, 4, 16), 4, 1, 22, 5, 5),
    (1, 16, 16, 256, 128, 0): (64, (1, 4, 16), 4, 1, 36, 9, 4),
    (8, 4, 4, 256, 256, 0): (64, (4, 4, 4), 2, 2, 36, 9, 4),
    (8, 4, 4, 256, 256, 512): (64, (4, 4, 4), 2, 2, 44, 11, 4),
    (8, 4, 4, 512, 256, 0): (64, (4, 4, 4), 2, 2, 72, 18, 4),
    (8, 8, 8, 128, 128, 256): (64, (1, 8, 8), 8, 1, 22, 5, 5),
    (8, 8, 8, 128, 128, 512): (64, (1, 8, 8), 8, 1, 26, 6, 5),
    (8, 8, 8, 128, 256, 0): (64, (1, 8, 8), 8, 2, 18, 4, 5),
    (8, 8, 8, 256, 128, 0): (64, (1, 8, 8), 8, 1, 36, 9, 4),
    (8, 8, 8, 256, 256, 0): (64, (1, 8, 8), 8, 2, 36, 8, 5),
    (8, 8, 8, 256, 256, 128): (64, (1, 8, 8), 8, 2, 38, 8, 5),
    (8, 8, 8, 256, 256, 512): (64, (1, 8, 8), 8, 2, 44, 8, 6),
    (8, 8, 8, 512, 128, 0): (64, (1, 8, 8), 8, 1, 72, 15, 5),
    (8, 8, 8, 512, 256, 0): (64, (1, 8, 8), 8, 2, 72, 8, 9),
    (8, 16, 16, 128, 128, 0): (64, (1, 4, 16), 32, 1, 18, 4, 5),
    (8, 16, 16, 128, 128, 256): (64, (1, 4, 16), 32, 1, 22, 4, 6),
    (8, 16, 16, 256, 128, 0): (64, (1, 4, 16), 32, 1, 36, 4, 9),
    (16, 4, 4, 256, 256, 0): (64, (4, 4, 4), 4, 2, 36, 9, 4),
    (16, 4, 4, 256, 256, 512): (64, (4, 4, 4), 4, 2, 44, 11, 4),
    (16, 4, 4, 512, 256, 0): (64, (4, 4, 4), 4, 2, 72, 15, 5),
    (16, 8, 8, 128, 128, 256): (64, (1, 8, 8), 16, 1, 22, 5, 5),
    (16, 8, 8, 128, 128, 512): (64, (1, 8, 8), 16, 1, 26, 6, 5),
    (16, 8, 8, 128, 256, 0): (64, (1, 8, 8), 16, 2, 18, 4, 5),
    (16, 8, 8, 256, 128, 0): (64, (1, 8, 8), 16, 1, 36, 8, 5),
    (16, 8, 8, 256, 256, 0): (64, (1, 8, 8), 16, 2, 36, 4, 9),
    (16, 8, 8, 256, 256, 128): (64, (1, 8, 8), 16, 2, 38, 4, 10),
    (16, 8, 8, 256, 256, 512): (64, (1, 8, 8), 16, 2, 44, 4, 11),
    (16, 8, 8, 512, 128, 0): (64, (1, 8, 8), 16, 1, 72, 8, 9),
    (16, 8, 8, 512, 256, 0): (64, (1, 8, 8), 16, 2, 72, 4, 18),
    (16, 16, 16, 128, 128, 0): (64, (1, 4, 16), 64, 1, 18, 2, 9),
    (16, 16, 16, 128, 128, 256): (64, (1, 4, 16), 64, 1, 22, 2, 11),
    (16, 16, 16, 256, 128, 0): (64, (1, 4, 16), 64, 1, 36, 2, 18),
})
#: the DiT's K3 call sites: (n, T, heads, D) at a serving and a training batch
LATENT_DIT_SITES = [(n, 64, 4, 64) for n in SERVE_BATCHES + (TRAIN_BATCH,)]


def test_latent_call_sites_per_forward():
    """Latent UNet: 6 attention calls (T = 64 with D = 256 three times and
    D = 128 twice, T = 4 once) and 22 ResBlocks down to 2x2; the config's
    UNet: T = 16 in the middle, 17 ResBlocks."""
    for widths, middle, res in (("latent", (8, 4, 1, 256), 22), ("latent_cfg", (8, 16, 1, 256),
                                                                  17)):
        sites = call_sites(8, widths)
        counts = {}
        for shape in sites["attention"]:
            counts[shape] = counts.get(shape, 0) + 1
        assert counts == {(8, 64, 1, 256): 3, (8, 64, 1, 128): 2, middle: 1}
        assert len(sites["resblock"]) == res
    assert {s[0][1] for s in call_sites(8, "latent")["resblock"]} == {16, 8, 4, 2}


def _latent_attention():
    for widths in ("latent", "latent_cfg"):
        for n in SERVE_BATCHES + (TRAIN_BATCH,):
            for shape in sorted(set(call_sites(n, widths)["attention"])):
                yield n, shape
    for shape in LATENT_DIT_SITES:
        yield shape[0], shape


@pytest.mark.parametrize("n,shape", list(_latent_attention()),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_latent_attention_plan_covers_every_key_tile_once(n, shape):
    _check_attention_plan(n, shape)
    for size in (2, 4):
        _check_attention_at(n, shape, size)


@pytest.mark.parametrize("n,shape,cout,proj", [
    (n, shape, cout, proj) for n in SERVE_BATCHES
    for shape, cout, proj in sorted(set(call_sites(n, "latent")["resblock"]))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_latent_resblock_plan_boxes_and_k_steps(n, shape, cout, proj):
    """K4 down to 2x2: a box of 16 samples of 2x2, past the batch at n = 1 and 8."""
    _check_resblock_plan(n, shape, cout, proj)


def test_latent_plans_are_pinned():
    seen_attn, seen_conv = {}, {}
    for widths in ("latent", "latent_cfg"):
        for n in SERVE_BATCHES + (TRAIN_BATCH,):
            for nn, t, h, d in set(call_sites(n, widths)["attention"]):
                plan = tuple(t_attention.attention_plan(nn, h, t, d, SMS))[:6]
                assert seen_attn.setdefault((t, h, d), plan) == plan
    for nn, t, h, d in LATENT_DIT_SITES:
        seen_attn[(t, h, d)] = tuple(t_attention.attention_plan(nn, h, t, d, SMS))[:6]
    for n in SERVE_BATCHES:
        for (nn, h, w, cin), cout, proj in set(call_sites(n, "latent")["resblock"]):
            for c_conv, c_proj in ((cin, 0), (cout, cin if proj else 0)):
                p = t_resblock.conv_plan(nn, h, w, c_conv, cout, c_proj, SMS)
                seen_conv[(nn, h, w, c_conv, cout, c_proj)] = (p.bm, p.box, p.m_tiles, p.n_tiles,
                                                               p.steps, p.splits, p.per)
    assert seen_attn == LATENT_ATTENTION
    assert seen_conv == LATENT_CONV


# K3 and K4 at both element sizes: 2 (bf16 and fp16, which share the 16-bit
# kernels and their plans) and 4 (f32: K3's 3xTF32 mma.sync kernel, K4's
# 3xTF32 wgmma convs). At every call site of every configuration above, the
# kernel's shared memory fits a block of an H100, a TMA box row (K3's 64-value
# panels in 16 bits; K4's K step) is 128 bytes, f32 rows copy in 16-byte
# pieces, and every key tile and K step falls in exactly one non-empty split.
BATCHES = {"cifar10": SERVE_BATCHES + (TRAIN_BATCH,), "lsun": LSUN_BATCHES,
           "iddpm": SERVE_BATCHES + (TRAIN_BATCH,), "iddpm64": SHAPES64_BATCHES,
           "latent": SERVE_BATCHES + (TRAIN_BATCH,), "latent_cfg": SERVE_BATCHES + (TRAIN_BATCH,)}


def _sites_by_size():
    for widths, batches in BATCHES.items():
        for size in (2, 4):
            yield widths, batches, size


def _check_attention_at(n, shape, size, trans=False):
    _, t, h, d = shape
    plan = t_attention.attention_plan(n, h, t, d, SMS, size, trans)
    assert t_attention.attention_smem(plan, size, trans) <= SMEM_MAX
    assert plan.dp % 64 == 0 and plan.dp - 64 < d <= plan.dp
    if size == 2:
        assert 64 * size == 128  # one swizzled panel row of Q, K, V and O
        assert plan == t_attention.attention_plan(n, h, t, d, SMS)  # bf16's plan
    else:
        bkv = 8 if plan.dp == 512 else 16 if trans and plan.dp == 256 else 32
        assert (plan.bq, plan.bkv) == (64, bkv)
        # 16-byte copies: along D row-major, along T (a multiple of 4) token-major
        assert plan.dp // plan.halves * size % 16 == 0 and d * size % 16 == 0
        assert not trans or (t % 4 == 0 and plan.dp <= 256)
    assert all(len(r) > 0 for r in plan.split_tiles())
    assert [j for r in plan.split_tiles() for j in r] == list(range(plan.kv_tiles))
    assert (plan.kv_tiles - 1) * plan.bkv < t <= plan.kv_tiles * plan.bkv
    assert plan.splits == 1 or plan.halves == 1


def _check_conv_at(n, shape, cout, proj, size):
    _, h, w, cin = shape
    bk = t_resblock.k_step(size)
    assert bk * size == 128  # the K step is one 128-byte row of the swizzle
    for c_conv, c_proj in ((cin, 0), (cout, cin if proj else 0)):
        plan = t_resblock.conv_plan(n, h, w, c_conv, cout, c_proj, SMS, size)
        assert t_resblock.conv_smem(plan, size) <= SMEM_MAX
        assert plan.steps == 9 * -(-c_conv // bk) + -(-c_proj // bk)
        assert [s for r in plan.slices() for s in r] == list(range(plan.steps))
        assert all(len(r) > 0 for r in plan.slices())
        assert plan.splits == 1 or plan.per >= t_resblock.MIN_STEPS
        # the tile and box do not depend on the element size; TMA strides of 16 bytes
        assert (plan.bm, plan.box) == (lambda p: (p.bm, p.box))(
            t_resblock.conv_plan(n, h, w, c_conv, cout, c_proj, SMS))
        assert all(c * size % 16 == 0 for c in (c_conv, cin, 9 * c_conv + c_proj))


@pytest.mark.parametrize("widths,batches,size", list(_sites_by_size()))
def test_plans_fit_at_both_element_sizes(widths, batches, size):
    for n in batches:
        sites = call_sites(n, widths)
        for shape in set(sites["attention"]):
            _check_attention_at(n, shape, size)
            if size == 4 and shape[1] % 4 == 0 and shape[3] <= 256:
                _check_attention_at(n, shape, size, trans=True)
        if n != TRAIN_BATCH:  # a training step runs no K4
            for shape, cout, proj in set(sites["resblock"]):
                _check_conv_at(n, shape, cout, proj, size)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 160, 192, 256, 512])
@pytest.mark.parametrize("n,t", [(1, 16), (1, 256), (8, 256), (128, 256), (1, 1024)])
def test_f32_attention_plans_at_every_head_dim(n, t, d):
    """The f32 kernel's head dims and grids: shared memory within a block's
    at D = 512 too (Q 64 x 516 floats and two stages of 16 keys), key splits
    only where the blocks fill at most half the SMs (16 bits: an eighth)."""
    _check_attention_at(n, (n, t, 1, d), 4)
    if d <= 256:
        _check_attention_at(n, (n, t, 1, d), 4, trans=True)
    plan32 = t_attention.attention_plan(n, 1, t, d, SMS, 4)
    blocks = plan32.q_tiles * n
    if plan32.splits > 1:
        assert plan32.halves == 1 and 2 * blocks <= SMS
        assert 1 < plan32.splits <= min(plan32.kv_tiles // 2, -(-SMS // blocks))
    elif plan32.halves == 1 and plan32.kv_tiles >= 4 and t * plan32.dp >= 256 * 256:
        assert 2 * blocks > SMS


def test_f32_shared_memory_by_head_dim():
    """TileF32::SMEM of csrc/attention.cu (row-major and token-major) and
    ConvSmem of csrc/resblock.cu at their instantiations, in bytes."""
    want = {(64, False): 54272, (128, False): 103424, (192, False): 152576,
            (256, False): 201728, (512, False): 183040, (64, True): 59392,
            (128, True): 118784, (192, True): 178176, (256, True): 172032}
    for (dp, trans), smem in want.items():
        plan = t_attention.attention_plan(8, 1, 256, dp, SMS, 4, trans)
        assert t_attention.attention_smem(plan, 4, trans) == smem
    assert t_attention.attention_smem(t_attention.attention_plan(8, 1, 256, 256, SMS)) == 99352
    p64 = t_resblock.conv_plan(8, 16, 16, 256, 256, 0, SMS, 4)
    p128 = t_resblock.conv_plan(8, 32, 32, 128, 128, 0, SMS, 4)
    assert (p64.bm, p128.bm) == (64, 128)
    assert t_resblock.conv_smem(p64, 4) == 1024 + 4 * 48 * 1024 + 64
    assert t_resblock.conv_smem(p128, 4) == 1024 + 3 * 64 * 1024 + 48
    assert t_resblock.conv_smem(p128, 2) == 1024 + 4 * 32 * 1024 + 64


def test_f32_layout_reads_the_projection_in_place():
    """The f32 kernel reads the qkv projection's views as they come: row-major
    (NHWC, unit stride along D) or token-major (the channel-major output of
    an f32 convolution, unit stride along T), and falls back to row-major
    copies for a T that is not a multiple of 4 or D = 512."""
    def views(n, t, h, d, channel_major):
        if channel_major:  # (N, 3C, T) storage seen as (N, T, 3, H, D)
            qkv = torch.empty((n, 3 * h * d, t), device="meta").transpose(1, 2)
            qkv = qkv.reshape(n, t, 3, h, d)
        else:
            qkv = torch.empty((n, t, 3, h, d), device="meta")
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    for n, t, h, d in ((128, 256, 1, 256), (8, 16, 1, 256), (8, 256, 4, 64), (8, 64, 4, 32)):
        dp = -(-d // 64) * 64
        assert not t_attention.f32_layout(*views(n, t, h, d, False), dp)
        assert t_attention.f32_layout(*views(n, t, h, d, True), dp)
        q = views(n, t, h, d, True)[0]
        assert q.stride(1) == 1 and t_attention._aligned(q, unit=1)
    assert t_attention.f32_layout(*views(2, 100, 2, 48, True), 64)
    assert not t_attention.f32_layout(*views(2, 98, 2, 48, True), 64)  # T % 4: unaligned
    assert not t_attention.f32_layout(*views(1, 64, 1, 512, True), 512)
