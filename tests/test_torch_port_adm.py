"""The port's ADM family against the JAX package's, on the same inputs.

The TINY widths of tests/test_adm.py (channels 32, mult (1, 2), one block a
level, attention at 8×8 with 16 channels a head) at 16×16: the generator
(unconditional, class-conditional) and the upsampler ADMU (6 → 12
channels), and the noisy classifier, each on seeded random weights (every
weight, the zero-initialised ``conv2``/``proj``/``out_conv`` included, so
the attention is seen) carried across by ``from_flax`` unchanged; outputs
within rtol 1e-4 / atol 1e-5 (``FWD_TOL`` of tests/test_torch_port_iddpm.py).
A fresh ADM outputs exactly 0, the feature cache replays the forward, the
full-width parameter counts equal ``jax.eval_shape``'s, and the attention
sites of the full-width ADM-32 and classifier-32 lie inside K3's plans.
Each JAX forward is jitted once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.models import adm as jax_adm
from dmme_tpu_torch.models import adm as t_adm
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.ops import SMEM_MAX
from dmme_tpu_torch.ops import attention as t_attention
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(8,), num_head_channels=16)
IMG = 16
N = 3
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
SMS = 132  # an H100 SXM
#: the builders of each variant: (JAX model, port model, input channels, conditional)
VARIANTS = {
    "uncond": (lambda m: m.ADM(IMG, class_conditional=False, **TINY), 3, False),
    "cond": (lambda m: m.ADMG(IMG, num_classes=10, **TINY), 3, True),
    "admu": (lambda m: m.ADMU(IMG, **TINY), 6, False),
}


def random_params(shapes, seed=0):
    """Seeded numpy values for a JAX parameter tree: kernels of variance
    1/fan_in (the zero-initialised ones too), GroupNorm scales near 1,
    non-zero biases, unit-variance label embeddings."""
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        elif name == "embedding":
            v = r.standard_normal(leaf.shape)
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(cin, seed=1):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N, IMG, IMG, cin)).astype(np.float32)
    return x, np.array([1, 17, 40], np.int32), np.array([3, 7, 1], np.int32)


@pytest.fixture(scope="module")
def generators():
    """{variant: (JAX model, params, port model with them loaded)}."""
    out = {}
    for name, (build, cin, cond) in VARIANTS.items():
        jm, tm = build(jax_adm), build(t_adm)
        args = (jnp.zeros((N, IMG, IMG, cin)), jnp.zeros((N,), jnp.int32))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(args + args[1:] * cond))
        params = random_params(shapes)
        tm.load_state_dict(from_flax(params), strict=True)
        out[name] = (jm, params, tm.eval())
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_adm_forward_matches_jax(generators, variant):
    jm, params, tm = generators[variant]
    _, cin, cond = VARIANTS[variant]
    x, t, y = _inputs(cin)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, *([y] if cond else [])))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(t), torch.tensor(y) if cond else None)
    assert got.shape == want.shape == (N, IMG, IMG, 2 * cin)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    if cond:  # the labels reach the output
        with torch.no_grad():
            other = tm(torch.tensor(x), torch.tensor(t), torch.ones(N, dtype=torch.int64))
        assert not torch.allclose(other, got)
        with pytest.raises(ValueError, match="needs labels"):
            tm(torch.tensor(x), torch.tensor(t))


def test_from_flax_names_are_the_port_modules(generators):
    """The flax tree flattens to exactly the port's state_dict keys, with the
    names the JAX tree shows."""
    jm, params, tm = generators["cond"]
    keys = set(from_flax(params))
    assert keys == set(tm.state_dict())
    for name in ("Dense_0.weight", "Dense_1.bias", "label_emb.weight", "input_conv.weight",
                 "down_0_0.norm1.weight", "down_0_0.emb_proj.weight", "down_0_0.conv2.weight",
                 "downsample_0.conv1.weight", "down_1_0.skip.weight",
                 "down_attn_1_0.GroupNorm_0.weight", "down_attn_1_0.qkv.weight",
                 "down_attn_1_0.proj.weight", "middle_0.norm2.bias", "middle_attn.qkv.bias",
                 "middle_1.conv1.weight", "up_1_1.skip.weight", "up_attn_1_1.proj.bias",
                 "upsample_1.conv2.weight", "up_0_0.conv1.weight", "out_norm.weight",
                 "out_conv.weight"):
        assert name in keys, name


def test_fresh_adm_outputs_exactly_zero():
    """conv2, every attention proj and out_conv start at zero, as flax's
    zeros init: the residual branches are the identity and the output 0."""
    model = t_adm.ADM(IMG, class_conditional=False, **TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        layer, kind = name.split(".")[-2:]
        if kind == "weight" and layer in ("conv2", "proj", "out_conv"):
            assert torch.count_nonzero(p) == 0, name
        elif kind == "weight" and layer in ("conv1", "qkv", "skip", "emb_proj"):
            assert torch.count_nonzero(p) == p.numel(), name
    x, t, _ = _inputs(3)
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(t))
    assert out.shape == (N, IMG, IMG, 6)
    assert torch.count_nonzero(out) == 0


def test_features_then_cached_gives_the_same_output(generators):
    """``return_features`` then ``cached=`` replays the decoder bit for bit,
    and the captured encoder state equals JAX's."""
    jm, params, tm = generators["uncond"]
    x, t, _ = _inputs(3, seed=4)
    with torch.no_grad():
        out, (h, skips) = tm(torch.tensor(x), torch.tensor(t), return_features=True)
        replay = tm(torch.tensor(x), torch.tensor(t), cached=(h, skips))
    torch.testing.assert_close(replay, out, rtol=0, atol=0)
    _, (jh, jskips) = jax.jit(lambda p, x, t: jm.apply(p, x, t, return_features=True))(
        params, x, t)
    assert len(skips) == len(jskips) == 4
    for got, want in zip((h,) + tuple(skips), (jh,) + tuple(jskips)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_encoder_unet_logits_match_jax():
    jm = jax_adm.classifier(IMG, num_classes=10, **TINY)
    tm = t_adm.classifier(IMG, num_classes=10, **TINY)
    x, t, _ = _inputs(3, seed=2)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros(x.shape), jnp.zeros((N,), jnp.int32)))
    sd = from_flax(params)
    assert {"pool_norm.weight", "pool_w.weight", "logits.weight", "logits.bias"} <= set(sd)
    tm.load_state_dict(sd, strict=True)
    want = np.asarray(jax.jit(jm.apply)(params, x, t))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(t))
    assert got.shape == want.shape == (N, 10)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def _count(tree) -> int:
    return int(sum(np.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("which,want", [("ADM", 57_094_662), ("classifier", 4_287_627)])
def test_full_width_parameter_counts(which, want):
    """The presets of configs/adm/{cifar10_guided,cifar10_classifier}.yaml:
    the port's modules (on the meta device) against ``jax.eval_shape`` of
    the JAX init, no JAX init run."""
    if which == "ADM":
        jm = jax_adm.ADM(image_size=32, class_conditional=False)
        with torch.device("meta"):
            tm = t_adm.ADM(image_size=32, class_conditional=False)
    else:
        jm = jax_adm.classifier(image_size=32, num_classes=10)
        with torch.device("meta"):
            tm = t_adm.classifier(image_size=32, num_classes=10)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,), jnp.int32))
    assert _count(shapes) == want
    assert sum(p.numel() for p in tm.parameters()) == want
    # the same tree: each flax leaf has its port tensor, transposed as from_flax does
    flat = {"/".join(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert len(flat) == len(tm.state_dict())


def attention_sites(model_fn, n):
    """(T, H, D) of every attention call of a full-width bf16 forward at
    batch ``n`` on the meta device (shapes only), in call order."""
    seen = []

    def record(q, k, v, scale):
        _, t, h, d = q.shape
        assert scale == d ** -0.5
        seen.append((t, h, d))
        return torch.empty_like(q)

    saved = t_adm.attention_heads
    t_adm.attention_heads = record
    try:
        with torch.device("meta"), torch.no_grad():
            model = model_fn()
            model(torch.empty((n, 32, 32, 3)), torch.zeros((n,), dtype=torch.int64))
    finally:
        t_adm.attention_heads = saved
    return seen


def test_adm_attention_sites_lie_in_k3s_plans():
    """ADM-32: 15 sites a forward, 4 heads of 64 at T = 256 (×7), 64 (×7) and
    16 (the middle, ×1); classifier-32: 5 sites, 2 heads of 64. Every shape
    has a K3 plan in bf16 and f32 at the serving, training and guided
    batches, within the shared memory of an SM."""
    gen = attention_sites(lambda: t_adm.ADM(32, class_conditional=False,
                                            dtype=torch.bfloat16), 1)
    clf = attention_sites(lambda: t_adm.classifier(32, num_classes=10, dtype=torch.bfloat16), 1)
    assert sorted(gen) == [(16, 4, 64)] + [(64, 4, 64)] * 7 + [(256, 4, 64)] * 7
    assert sorted(clf) == [(16, 2, 64)] + [(64, 2, 64)] * 2 + [(256, 2, 64)] * 2
    for n in (1, 8, 16, 128, 256):
        for t, h, d in set(gen) | set(clf):
            for size in (2, 4):
                plan = t_attention.attention_plan(n, h, t, d, SMS, size)
                assert plan.dp == 64 and plan.q_tiles * plan.bq >= t
                assert t_attention.attention_smem(plan, size) <= SMEM_MAX
