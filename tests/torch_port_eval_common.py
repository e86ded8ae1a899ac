"""Shared fixtures and helpers of the evaluation tests
(``tests/test_torch_port_eval_{stats,loop,fid_tool}.py``): the port against
the JAX package on the same seeded numpy Inception weights.

JAX's Inception tree has the structure of ``init`` (``jax.eval_shape``) with
every kernel and bias drawn (flax zero-initialises biases, which would hide
a dropped one), carried into the port by ``from_flax`` (``carried``); the
BN-folding loaders read the randomised ``state_dict`` of
tests/torch_inception.py's twin (``twin``). JAX's ``make_feature_fn`` is
stood in by its own body built from one ``load_torch_weights`` tree
(``_jax_feature_fn``): its jitted ``init`` of the full network takes over a
minute on one core.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.eval import inception as jinc
from dmme_tpu_torch.eval import inception as tinc
from dmme_tpu_torch.utils.convert import from_flax
from tests.torch_inception import TorchInceptionV3, randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_RTOL = 1e-6
TEST_RTOL = 1e-5
#: what two f32 accumulation orders leave of a cancelling closed form (test()'s docstring)
F32_CANCEL_RTOL = 1e-3
#: the self-FID of a few images at these weights from f32 sums: −0.035 to −0.04 measured
SELF_FID_FLOOR = 0.1
VARIANTS = ("fid", "torchvision")
TINY_UNET = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8),
                 num_blocks=1, fused_norm=True, fused_block=True)
RESULT_KEYS = {"fid", "inception_score", "inception_score_std", "num_batches", "use_ema",
               "sampler", "sample_steps"}


@functools.lru_cache(maxsize=None)
def _shapes(variant):
    """JAX's Inception tree as ``init`` builds it, without its values."""
    return jax.eval_shape(jinc.InceptionV3(variant=variant).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 75, 75, 3), jnp.float32))


def _jax_params(variant, seed):
    """JAX's tree with every leaf drawn: He-scaled kernels, biases N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _shapes(variant))


@pytest.fixture(scope="module")
def carried():
    """{variant: (JAX's params, the port's InceptionV3 with them, JAX's jitted apply)}."""
    out = {}
    for i, variant in enumerate(VARIANTS):
        params = _jax_params(variant, 10 + i)
        model = tinc.InceptionV3(variant=variant)
        model.load_state_dict(from_flax(params), strict=True)
        out[variant] = (params, model.eval(), jax.jit(jinc.InceptionV3(variant=variant).apply))
    return out


def _he_randomize(model, seed):
    """``randomize`` (random weights and BN running statistics) at He scale:
    its N(0, 0.1²) kernels make the 2048 features nearly constant over the
    inputs, which would leave every FID ≈ 0."""
    randomize(model, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
        model.fc.weight.copy_(torch.randn(model.fc.weight.shape, generator=g) / 2048 ** 0.5)
    return model


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """{variant: (tests/torch_inception.py's twin at He scale, its state_dict file)}."""
    root = tmp_path_factory.mktemp("inception")
    out = {}
    for variant in VARIANTS:
        tm = _he_randomize(TorchInceptionV3(variant=variant), seed=3)
        path = str(root / f"{variant}.pth")
        torch.save(tm.state_dict(), path)
        out[variant] = (tm, path)
    return out


@functools.lru_cache(maxsize=None)
def _jax_feature_fn(weights_path=None, num_classes=None, variant="auto"):
    """JAX's ``make_feature_fn`` on a weights file, with the tree's structure
    from ``eval_shape`` in place of its jitted ``init`` (every leaf is loaded
    from the file); one per file, so its compilations are reused."""
    assert weights_path is not None and variant == "auto"
    variant, _ = jinc.detect_variant(weights_path)
    model = jinc.InceptionV3(variant=variant)
    params = jinc.load_torch_weights(_shapes(variant), weights_path)
    return jax.jit(lambda x: model.apply(params, jinc.preprocess(x)))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, rtol):
    assert abs(got - want) <= rtol * abs(want), (got, want)



@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("fid_tool")
    rng = np.random.RandomState(0)
    a = rng.rand(4, 16, 16, 3).astype(np.float32)
    b = np.clip(a + 0.35 * rng.rand(4, 16, 16, 3).astype(np.float32), 0, 1)
    np.save(root / "a.npy", a)
    np.save(root / "b.npy", b)
    (root / "a_png").mkdir()
    quant = (a * 255).round().astype(np.uint8)
    for i, img in enumerate(quant):
        Image.fromarray(img).save(root / "a_png" / f"{i:03d}.png")
    np.save(root / "a_q.npy", quant)  # the PNGs' 8-bit pixels
    return root
