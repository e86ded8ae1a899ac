"""K1/K2's launch plan (``ops/group_norm.py:gn_plan``) and the order of its
sums, checked on the CPU.

The plan is checked at the 45 GroupNorm+SiLU sites of a full-width
batch-128 training step (the DDPM and IDDPM UNets have the same sites), at
the serving ``out_norm`` site at batch 1, 8 and 16, and at the
GroupNorm+SiLU sites of the LSUN widths (``configs/ddpm/lsun_*.yaml``,
256×256) at batch 1 and 2, and at the sites of latent diffusion's default
UNet on 16×16×4 latents (training at batch 128, ``out_norm`` at 1, 8, 16),
for 2-byte elements (bf16 and fp16, which share
every plan) and 4-byte ones (f32); the sites come from UNet forwards on
PyTorch's meta device. The card is an H100 SXM: 132 SMs, 227 KB of shared
memory a block, clusters of up to 8 blocks (the portable size).

The kernels themselves run only on the card. Here an emulation of their
reduction order (per-block channel partials over each block's pixels, summed
in block order, then a group's channels in order; the pre-bias folded into
the sums) is held against the plain versions and against the JAX package's
Pallas kernels in interpret mode, in one pass and in two, at
tests/test_ops.py's tolerances: rtol 2e-4 / atol 2e-5 forward, 2e-3 / 2e-4
backward. The order depends on the plan alone, not on the element type
(every thread owns 8 channels in every dtype), so f32 inputs under the f32
plans check it for all three.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmme_tpu_torch.models.blocks as blocks
from dmme_tpu_torch.models import ddpm as ddpm_models
from dmme_tpu_torch.models import iddpm as iddpm_models
from dmme_tpu_torch.ops import group_norm as t_gn

torch.set_num_threads(1)

jax_gn = importlib.import_module("dmme_tpu.ops.group_norm")

SMS = 132
GN_TOL = dict(rtol=2e-4, atol=2e-5)
GN_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# (H, W, C): GroupNorm+SiLU sites of one batch-128 training step of the
# CIFAR-10 UNet (x in bf16, G = 32)
TRAIN_SITES = {(4, 4, 256): 11, (4, 4, 512): 3, (8, 8, 256): 7, (8, 8, 512): 3,
               (16, 16, 128): 3, (16, 16, 256): 5, (16, 16, 512): 2, (32, 32, 128): 8,
               (32, 32, 256): 3}
LSUN = dict(channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))


@functools.lru_cache(maxsize=None)
def gn_sites(n: int, img: int, lsun: bool, iddpm: bool = False, channels: int = 3) -> tuple:
    """The (N, H, W, C) of every GroupNorm+SiLU call of a UNet forward with
    ``fused_norm`` on and ``fused_block`` off (as in training): the DDPM
    UNet, at the LSUN widths with ``lsun``, or the IDDPM UNet; ``channels``
    in (4: latent diffusion's default UNet on img×img×4 latents)."""
    seen = []

    def gn_silu(x, gamma, beta, groups, eps=None, pre_bias=None):
        seen.append(tuple(x.shape))
        return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)

    def attention(q, k, v, scale):
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    patched = {"group_norm_silu": gn_silu, "attention_heads": attention}
    saved = {k: getattr(blocks, k) for k in patched}
    try:
        for k, fn in patched.items():
            setattr(blocks, k, fn)
        with torch.device("meta"), torch.no_grad():
            factory = iddpm_models.UNet if iddpm else ddpm_models.UNet
            model = factory(in_channels=channels, dtype=torch.bfloat16, fused_norm=True,
                            **(LSUN if lsun else {}))
            model(torch.empty((n, img, img, channels)), torch.zeros((n,), dtype=torch.int64))
    finally:
        for k, fn in saved.items():
            setattr(blocks, k, fn)
    return tuple(seen)


def _site_counts(sites) -> dict:
    counts = {}
    for _, h, w, c in sites:
        counts[(h, w, c)] = counts.get((h, w, c), 0) + 1
    return counts


def test_training_sites_match_the_table():
    sites = gn_sites(128, 32, False)
    assert len(sites) == 45
    assert _site_counts(sites) == TRAIN_SITES


def test_iddpm_training_sites_match_the_table():
    """The IDDPM UNet (FiLM, 4 heads) has the DDPM UNet's 45 sites."""
    sites = gn_sites(128, 32, False, iddpm=True)
    assert len(sites) == 45
    assert _site_counts(sites) == TRAIN_SITES


def _check_plan(n, h, w, c, backward, size=2):
    plan = t_gn.gn_plan(n, h, w, c, 32, SMS, backward, size)
    hw = h * w
    pixels = [p for r in plan.ranges(hw) for p in r]
    assert pixels == list(range(hw)) and all(len(r) for r in plan.ranges(hw))
    assert plan.threads * t_gn.VEC >= c
    fits = t_gn._smem_bytes(backward, -(-hw // t_gn.MAX_CLUSTER), c, t_gn.THREADS,
                            size) <= t_gn.SMEM_MAX
    if plan.two_pass:
        assert not fits and plan.threads == t_gn.THREADS
        assert plan.pixels * size * c * (2 if backward else 1) <= t_gn.TWO_PASS_BYTES
        return plan
    assert plan.blocks in (t_gn.F32_FWD_CLUSTERS if size == 4 and not backward
                           else t_gn.CLUSTERS)
    # K1: 512 threads; K2: 256 where two blocks share an SM, else 512
    two_a_sm = t_gn._smem_bytes(True, plan.pixels, c, t_gn.THREADS, size) <= t_gn.HALF_SM
    wide_fits = (t_gn._smem_bytes(backward, plan.pixels, c, t_gn.WIDE_THREADS, size)
                 <= t_gn.SMEM_MAX)
    narrow = (backward and two_a_sm) or not wide_fits
    assert plan.threads == (t_gn.THREADS if narrow else t_gn.WIDE_THREADS)
    assert plan.smem == t_gn._smem_bytes(backward, plan.pixels, c, plan.threads, size)
    assert plan.smem <= t_gn.SMEM_MAX  # 227 KB a block
    assert -(-plan.pixels // plan.chunk) <= t_gn.MAX_CHUNKS
    # each bulk copy at most 32 KB a tensor unless that would take more than 16 copies
    assert (plan.chunk * size * c <= t_gn.CHUNK_BYTES
            or plan.chunk == -(-plan.pixels // t_gn.MAX_CHUNKS))
    return plan


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("h,w,c", sorted(TRAIN_SITES))
def test_plan_at_training_sites(h, w, c, backward):
    """One pass at every training site: each sample in one cluster, up to
    8 blocks that hold it in shared memory."""
    plan = _check_plan(128, h, w, c, backward)
    assert not plan.two_pass
    # the smallest cluster of 1, 2, 8 whose slabs hold 128 KB at most: the
    # batch alone fills the SMs, so no cluster widens
    bpp = 2 * c * (2 if backward else 1)
    assert plan.blocks == next(k for k in (1, 2, 8) if -(-h * w // k) * bpp <= 128 * 1024)


# f32 (4-byte) plans at the training sites, (blocks, pixels, threads, two
# passes) of K1 and K2. K1 takes clusters of 4 at 16x16x512 (0.0928 ms on an
# H100 against 0.1212 in clusters of 8) and at 32x32x128 (a tie, 0.0873 ms).
# K2 at 32x32x256 (x and dz 2 MiB a sample) takes two passes over chunks of
# 32 pixels: a cluster of 8 cannot hold it, and one of 16 (128 KB of x and
# dz a block) took 0.3158 ms against two passes' 0.2963 there on an H100
# (PERF.md)
F32_TRAIN_PLANS = {
    (4, 4, 256): ((1, 16, 512, False), (1, 16, 256, False)),
    (4, 4, 512): ((1, 16, 512, False), (1, 16, 256, False)),
    (8, 8, 256): ((1, 64, 512, False), (1, 64, 512, False)),
    (8, 8, 512): ((1, 64, 512, False), (2, 32, 512, False)),
    (16, 16, 128): ((1, 256, 512, False), (2, 128, 512, False)),
    (16, 16, 256): ((2, 128, 512, False), (8, 32, 256, False)),
    (16, 16, 512): ((4, 64, 512, False), (8, 32, 512, False)),
    (32, 32, 128): ((4, 256, 512, False), (8, 128, 512, False)),
    (32, 32, 256): ((8, 128, 512, False), (32, 32, 256, True)),
}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("h,w,c", sorted(TRAIN_SITES))
def test_f32_plan_at_training_sites(h, w, c, backward):
    """f32 takes the plans pinned above at every training site; fp16 takes
    bf16's plan there."""
    plan = _check_plan(128, h, w, c, backward, size=4)
    assert ((plan.blocks, plan.pixels, plan.threads, plan.two_pass)
            == F32_TRAIN_PLANS[(h, w, c)][backward])
    assert t_gn.gn_plan(128, h, w, c, 32, SMS, backward, 2) == t_gn.gn_plan(
        128, h, w, c, 32, SMS, backward)


@pytest.mark.parametrize("n", [1, 8, 16])
def test_plan_at_the_serving_site(n):
    """``out_norm``, the one K1 site of a serving forward, 32x32x128."""
    assert (n, 32, 32, 128) in gn_sites(n, 32, False)
    plan = _check_plan(n, 32, 32, 128, False)
    # few samples: the cluster widens toward the SMs, 8 blocks of 128 pixels
    assert (plan.blocks, plan.pixels, plan.two_pass) == (8, 128, False)
    assert plan.threads == t_gn.WIDE_THREADS


# latent diffusion: the default latent UNet's 45 sites at batch 128 on
# 16x16x4 latents, down to 2x2 (a group of 8 channels there holds 32 values),
# and the (blocks, pixels, threads, two passes) of K1 and K2 in bf16 and f32;
# its one serving site, out_norm at 16x16x128
LATENT_SITES = {(2, 2, 256): 11, (2, 2, 512): 3, (4, 4, 256): 7, (4, 4, 512): 3,
                (8, 8, 128): 3, (8, 8, 256): 5, (8, 8, 512): 2, (16, 16, 128): 8,
                (16, 16, 256): 3}
LATENT_PLANS = {  # {(H, W, C): ((K1 bf16, K2 bf16), (K1 f32, K2 f32))}
    (2, 2, 256): (((1, 4, 512, False), (1, 4, 256, False)),) * 2,
    (2, 2, 512): (((1, 4, 512, False), (1, 4, 256, False)),) * 2,
    (4, 4, 256): (((1, 16, 512, False), (1, 16, 256, False)),) * 2,
    (4, 4, 512): (((1, 16, 512, False), (1, 16, 256, False)),) * 2,
    (8, 8, 128): (((1, 64, 512, False), (1, 64, 256, False)),) * 2,
    (8, 8, 256): (((1, 64, 512, False), (1, 64, 256, False)),
                  ((1, 64, 512, False), (1, 64, 512, False))),
    (8, 8, 512): (((1, 64, 512, False), (1, 64, 512, False)),
                  ((1, 64, 512, False), (2, 32, 512, False))),
    (16, 16, 128): (((1, 256, 512, False), (1, 256, 512, False)),
                    ((1, 256, 512, False), (2, 128, 512, False))),
    (16, 16, 256): (((1, 256, 512, False), (2, 128, 512, False)),
                    ((2, 128, 512, False), (8, 32, 256, False))),
}


def test_latent_training_sites_match_the_table():
    sites = gn_sites(128, 16, False, channels=4)
    assert len(sites) == 45 and _site_counts(sites) == LATENT_SITES


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("h,w,c", sorted(LATENT_SITES))
def test_plan_at_latent_training_sites(h, w, c, backward, size):
    plan = _check_plan(128, h, w, c, backward, size)
    got = (plan.blocks, plan.pixels, plan.threads, plan.two_pass)
    assert got == LATENT_PLANS[(h, w, c)][size == 4][backward]


@pytest.mark.parametrize("n", [1, 8, 16])
def test_plan_at_the_latent_serving_site(n):
    assert (n, 16, 16, 128) in gn_sites(n, 16, False, channels=4)
    plan = _check_plan(n, 16, 16, 128, False)
    assert (plan.blocks, plan.pixels, plan.threads, plan.two_pass) == (8, 32, 512, False)


def _lsun_shapes():
    for n in (1, 2):
        for shape in sorted(set(gn_sites(n, 256, True))):
            yield shape


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", list(_lsun_shapes()), ids=lambda s: "x".join(map(str, s)))
def test_plan_at_lsun_sites(shape, backward):
    """The LSUN widths reach samples that no cluster of 8 holds (256x256 and
    128x128 layers): those take two passes."""
    n, h, w, c = shape
    plan = _check_plan(n, h, w, c, backward)
    if h * w * c >= 128 * 128 * 128:
        assert plan.two_pass


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", list(_lsun_shapes()), ids=lambda s: "x".join(map(str, s)))
def test_f32_plan_at_lsun_sites(shape, backward):
    """f32 at the LSUN widths: the layers that take two passes in bf16 take
    them in f32 too."""
    n, h, w, c = shape
    plan = _check_plan(n, h, w, c, backward, size=4)
    if t_gn.gn_plan(n, h, w, c, 32, SMS, backward).two_pass:
        assert plan.two_pass


def test_plan_cache_and_errors():
    assert t_gn.gn_plan(8, 8, 8, 256, 32, SMS) is t_gn.gn_plan(8, 8, 8, 256, 32, SMS)
    assert t_gn.gn_plan(8, 8, 8, 96, 32, SMS).threads == t_gn.WIDE_THREADS  # C/G = 3
    with pytest.raises(ValueError, match="groups"):
        t_gn.gn_plan(1, 4, 4, 40, 32, SMS)
    with pytest.raises(ValueError, match="C % 8"):
        t_gn.gn_plan(1, 4, 4, 36, 12, SMS)
    with pytest.raises(ValueError, match="C % 8"):
        t_gn.gn_plan(1, 4, 4, 4096, 32, SMS)


# ------------------------------------------------------- the kernels' sums
def _ordered_sum(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _channel_totals(v, ranges):
    """(C,) totals of a sample's (HW, C) values: block partials in order."""
    return _ordered_sum([v[r.start:r.stop].sum(dim=0) for r in ranges])


def _group_sums(per_channel, groups):
    """(G,) sums over each group's channels in order."""
    cg = per_channel.shape[0] // groups
    return _ordered_sum([per_channel[i::cg] for i in range(cg)])


def emulate_fwd(x, gamma, beta, bias, groups, eps, plan):
    """K1's arithmetic in its order of sums, f32: returns (y, mean, inv)."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    ranges = plan.ranges(hw)
    gamma, beta = t_gn.broadcast_rows(gamma, n, c)[0], t_gn.broadcast_rows(beta, n, c)[0]
    bias = torch.zeros((n, c)) if bias is None else t_gn.broadcast_rows(bias, n, c)[0]
    ys, means, invs = [], [], []
    for i in range(n):
        v = x[i].reshape(hw, c).float()
        s, q = _channel_totals(v, ranges), _channel_totals(v * v, ranges)
        b = bias[i]
        cnt = float(hw * cg)
        mean = _group_sums(s + hw * b, groups) / cnt
        inv = torch.rsqrt(_group_sums(q + 2 * b * s + hw * b * b, groups) / cnt
                          - mean * mean + eps)
        a = inv.repeat_interleave(cg) * gamma[i]
        d = beta[i] + (b - mean.repeat_interleave(cg)) * a
        y = v * a + d
        ys.append((y * torch.sigmoid(y)).reshape(h, w, c))
        means.append(mean)
        invs.append(inv)
    return torch.stack(ys), torch.stack(means), torch.stack(invs)


def emulate_bwd(x, dz, gamma, beta, bias, mean, inv, groups, plan):
    """K2's arithmetic in its order of sums, f32: (dx, dγ, dβ, dbias)."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    ranges = plan.ranges(hw)
    gamma, beta = t_gn.broadcast_rows(gamma, n, c)[0], t_gn.broadcast_rows(beta, n, c)[0]
    bias = torch.zeros((n, c)) if bias is None else t_gn.broadcast_rows(bias, n, c)[0]
    out = [[], [], [], []]
    for i in range(n):
        v, g = x[i].reshape(hw, c).float(), dz[i].reshape(hw, c).float()
        iv = inv[i].repeat_interleave(cg)
        xh = (v + bias[i] - mean[i].repeat_interleave(cg)) * iv
        y = xh * gamma[i] + beta[i]
        s = torch.sigmoid(y)
        dy = g * (s * (1 + y * (1 - s)))
        dbeta, dgamma = _channel_totals(dy, ranges), _channel_totals(dy * xh, ranges)
        m1 = (_group_sums(dbeta * gamma[i], groups) / (hw * cg)).repeat_interleave(cg)
        m2 = (_group_sums(dgamma * gamma[i], groups) / (hw * cg)).repeat_interleave(cg)
        du = iv * (dy * gamma[i] - m1 - xh * m2)
        for lst, t in zip(out, (du.reshape(h, w, c), dgamma, dbeta, _channel_totals(du, ranges))):
            lst.append(t)
    return tuple(torch.stack(t) for t in out)


def _inputs(seed, n, h, w, c):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(n, h, w, c), f(n, h, w, c), 1.0 + 0.1 * f(n, c), 0.1 * f(n, c), 0.2 * f(n, c))


# (N, H, W, C, G, plan): one pass in a cluster of 3 ragged blocks, one in a
# single block, one in a cluster of 8 (the most the kernels take) whose last
# block holds 4 pixels of 6, and two passes over chunks of 5 pixels; C/G = 3
# and 4
EMULATED = {
    "one_pass_cluster_cg3": (2, 4, 6, 24, 8, t_gn.GNPlan(3, 9, 4, 256, 0, False)),
    "one_pass_block_cg4": (2, 4, 4, 32, 8, t_gn.GNPlan(1, 16, 16, 256, 0, False)),
    "one_pass_cluster8_ragged_cg4": (2, 2, 23, 16, 4, t_gn.GNPlan(8, 6, 2, 256, 0, False)),
    "two_pass_cg3": (3, 5, 4, 48, 16, t_gn.GNPlan(4, 5, 5, 256, 0, True)),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_forward_matches_plain_and_pallas(case):
    n, h, w, c, groups, plan = EMULATED[case]
    assert [p for r in plan.ranges(h * w) for p in r] == list(range(h * w))
    x, _, gamma, beta, bias = _inputs(7, n, h, w, c)
    t = torch.tensor
    got = emulate_fwd(t(x), t(gamma), t(beta), t(bias), groups, 1e-5, plan)
    plain = t_gn.gn_silu_plain(t(x), t(gamma), t(beta), t(bias), groups, 1e-5)
    y, mean, inv = jax_gn._fwd_pallas(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                      jnp.asarray(bias), groups, 1e-5, n, interpret=True)
    for name, g, p, j in zip(("y", "mean", "inv"), got, plain, (y, mean, inv)):
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **GN_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name, **GN_TOL)


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_backward_matches_plain_and_pallas(case):
    n, h, w, c, groups, plan = EMULATED[case]
    x, dz, gamma, beta, bias = _inputs(8, n, h, w, c)
    j = [jnp.asarray(a) for a in (x, gamma, beta, bias)]
    _, mean, inv = jax_gn._fwd_pallas(*j, groups, 1e-5, n, interpret=True)
    want = jax_gn._bwd_pallas(*j, mean, inv, jnp.asarray(dz), groups, 1e-5, n, interpret=True)
    t = torch.tensor
    args = (t(x), t(dz), t(gamma), t(beta), t(bias), t(np.asarray(mean)), t(np.asarray(inv)))
    got = emulate_bwd(*args, groups, plan)
    plain = t_gn.gn_silu_bwd_plain(*args, groups)
    for name, g, p, w_ in zip(("dx", "dgamma", "dbeta", "dbias"), got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **GN_GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **GN_GRAD_TOL)


def test_emulated_plan_of_a_real_site_matches_plain():
    """The emulation under the plan the card would take at a serving size:
    a shared (C,) affine, no pre-bias, C/G = 3."""
    plan = t_gn.gn_plan(2, 8, 8, 96, 32, SMS)
    x = torch.tensor(_inputs(9, 2, 8, 8, 96)[0])
    gamma, beta = torch.linspace(0.5, 1.5, 96), torch.linspace(-0.2, 0.2, 96)
    got = emulate_fwd(x, gamma, beta, None, 32, 1e-5, plan)
    want = t_gn.gn_silu_plain(x, gamma, beta, None, 32, 1e-5)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), **GN_TOL)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_emulated_f32_plan_of_the_largest_site(backward):
    """The emulation under the f32 plans the card takes at 32x32x256 (K1: a
    cluster of 8 blocks of 128 pixels; K2: two passes over 32 chunks of 32),
    on one sample with per-sample affines and a pre-bias, against the plain
    versions and the Pallas kernels in interpret mode."""
    n, h, w, c, groups = 1, 32, 32, 256, 32
    plan = t_gn.gn_plan(n, h, w, c, groups, SMS, backward, 4)
    assert plan == t_gn.gn_plan(128, h, w, c, groups, SMS, backward, 4)
    assert (plan.blocks, plan.two_pass) == ((32, True) if backward else (8, False))
    x, dz, gamma, beta, bias = _inputs(10, n, h, w, c)
    j = [jnp.asarray(a) for a in (x, gamma, beta, bias)]
    y, mean, inv = jax_gn._fwd_pallas(*j, groups, 1e-5, n, interpret=True)
    t = torch.tensor
    if not backward:
        got = emulate_fwd(t(x), t(gamma), t(beta), t(bias), groups, 1e-5, plan)
        plain = t_gn.gn_silu_plain(t(x), t(gamma), t(beta), t(bias), groups, 1e-5)
        names, want, tol = ("y", "mean", "inv"), (y, mean, inv), GN_TOL
    else:
        args = (t(x), t(dz), t(gamma), t(beta), t(bias), t(np.asarray(mean)),
                t(np.asarray(inv)))
        got = emulate_bwd(*args, groups, plan)
        plain = t_gn.gn_silu_bwd_plain(*args, groups)
        want = jax_gn._bwd_pallas(*j, mean, inv, jnp.asarray(dz), groups, 1e-5, n,
                                  interpret=True)
        names, tol = ("dx", "dgamma", "dbeta", "dbias"), GN_GRAD_TOL
    for name, g, p, w_ in zip(names, got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **tol)
