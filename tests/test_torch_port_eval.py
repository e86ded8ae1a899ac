"""Evaluation in the port against the JAX package: FID, the Inception Score,
InceptionV3, ``test()`` and the FID tool.

The networks run on the same seeded numpy weights: JAX's Inception tree has
the structure of ``init`` (``jax.eval_shape``) with every kernel and bias
drawn (flax zero-initialises biases, which would hide a dropped one), carried
into the port by ``from_flax``; the BN-folding loaders read the randomised
``state_dict`` of tests/torch_inception.py's twin. Tolerances: rtol 1e-4 /
atol 1e-5 for features and logits, 1e-6 relative for FID and IS on the same
features, 1e-5 relative for ``test()``'s results on the same images.

``test()`` samples ``lit.diffusion_model``, as JAX's does: for the
comparison with JAX's ``test()`` generation is stubbed in both packages to
return the same arrays (uniform draws from JAX's key of batch i), since the
two packages' random streams cannot match. JAX's ``make_feature_fn`` is
stood in by its own body built from one ``load_torch_weights`` tree: its
jitted ``init`` of the full network takes over a minute on one core.
"""

import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.fid as jax_fid_tool
from dmme_tpu.data import CIFAR10 as JaxCIFAR10
from dmme_tpu.diffusion import DDIM as JaxDDIM
from dmme_tpu.diffusion import make_sampler as jax_make_sampler
from dmme_tpu.eval import fid as jfid
from dmme_tpu.eval import inception as jinc
from dmme_tpu.eval import inception_score as jis
from dmme_tpu.training import evaluate as jevaluate
from dmme_tpu_torch import eval as teval
from dmme_tpu_torch import fid as fid_tool
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch.eval import fid as tfid
from dmme_tpu_torch.eval import inception as tinc
from dmme_tpu_torch.eval import inception_score as tis
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.models.vae import ConvVAE
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import LitDDIM, LitIDDPM, LitUpsampler, LitVAE
from dmme_tpu_torch.training import evaluate as tevaluate
from dmme_tpu_torch.utils.convert import from_flax
from dmme_tpu_torch.utils.norm import denorm
from tests.torch_inception import TorchInceptionV3, randomize

torch.set_num_threads(1)

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


# ------------------------------------------------------------------ FID, IS
def test_feature_stats_update_merge_and_moments_match_jax():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((16, 64)) + 3.0).astype(np.float32)
    b = (rng.standard_normal((8, 64)) * 2.0 - 1.0).astype(np.float32)
    j = jfid.FeatureStats.create(64).update(jnp.asarray(a)).update(jnp.asarray(b))
    t = tfid.FeatureStats.create(64).update(torch.from_numpy(a)).update(torch.from_numpy(b))
    jm = jfid.FeatureStats.create(64).update(jnp.asarray(a)).merge(
        jfid.FeatureStats.create(64).update(jnp.asarray(b)))
    tm = tfid.FeatureStats.create(64).update(torch.from_numpy(a)).merge(
        tfid.FeatureStats.create(64).update(torch.from_numpy(b)))
    for got, want in ((t, j), (tm, jm), (tm, j)):
        assert got.outer.dtype == torch.float32 and float(got.n) == float(want.n) == 24
        np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.outer.numpy(), np.asarray(want.outer), rtol=1e-6,
                                   atol=1e-4)
        for g, w in zip(got.moments(), want.moments()):
            assert g.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    one = tfid.FeatureStats.create(4).update(torch.ones(1, 4))
    with pytest.raises(AssertionError, match="at least 2 samples"):
        one.moments()


def test_frechet_distance_equals_jax_and_its_closed_forms():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((12, 12))
    c1, c2 = m @ m.T + np.eye(12), np.diag(rng.random(12) + 0.5)
    mu1, mu2 = rng.standard_normal(12), rng.standard_normal(12)
    assert tfid.frechet_distance(mu1, c1, mu2, c2) == jfid.frechet_distance(mu1, c1, mu2, c2)
    assert tfid._sqrtm_product(c1, c2) == jfid._sqrtm_product(c1, c2)
    assert abs(tfid.frechet_distance(mu1, c1, mu1, c1)) < 1e-9 * np.trace(c1)
    s1, s2, m1, m2 = 2.0, 0.5, 0.3, -1.2  # univariate: (m1 − m2)² + s1 + s2 − 2√(s1 s2)
    want = (m1 - m2) ** 2 + s1 + s2 - 2.0 * np.sqrt(s1 * s2)
    _close(tfid.frechet_distance(np.array([m1]), np.array([[s1]]), np.array([m2]),
                                 np.array([[s2]])), want, 1e-12)


def test_fid_real_stats_load_in_both_packages_and_reset(tmp_path):
    rng = np.random.default_rng(2)
    real = (rng.standard_normal((40, 16)) + 1.0).astype(np.float32)
    fake = (rng.standard_normal((40, 16)) * 1.5).astype(np.float32)
    j, t = jfid.FrechetInceptionDistance(dim=16), tfid.FrechetInceptionDistance(dim=16)
    j.update(jnp.asarray(real), real=True)
    j.update(jnp.asarray(fake), real=False)
    t.update(torch.from_numpy(real), real=True)
    t.update(torch.from_numpy(fake), real=False)
    want = j.compute()
    _close(t.compute(), want, METRIC_RTOL)
    t.save_real_stats(str(tmp_path / "port.npz"))
    j.save_real_stats(str(tmp_path / "jax.npz"))
    for path, other in (("port.npz", jfid.FrechetInceptionDistance(dim=16)),
                        ("jax.npz", tfid.FrechetInceptionDistance(dim=16))):
        other.load_real_stats(str(tmp_path / path))
        other.update(jnp.asarray(fake) if isinstance(other, jfid.FrechetInceptionDistance)
                     else torch.from_numpy(fake), real=False)
        _close(other.compute(), want, METRIC_RTOL)
    t.reset()  # the fake statistics go, the real ones stay
    assert float(t.fake.n) == 0 and float(t.real.n) == 40
    cleared = tfid.FrechetInceptionDistance(dim=16, reset_real_features=True)
    cleared.update(torch.from_numpy(real), real=True)
    cleared.reset()
    assert float(cleared.real.n) == 0 and float(cleared.fake.n) == 0


def test_inception_score_matches_jax():
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((8, 10)) * 3.0).astype(np.float32) for _ in range(2)]
    j, t = jis.InceptionScore(), tis.InceptionScore()
    for lg in batches:
        j.update(jnp.asarray(lg))
        t.update(torch.from_numpy(lg))
    assert t.num_classes == j.num_classes == 10  # sized from the first logits
    for got, want in zip(t.compute(), j.compute()):
        _close(got, want, METRIC_RTOL)
    _close(t.score(), j.score(), METRIC_RTOL)
    uniform = tis.InceptionScore(num_classes=5)
    uniform.update(torch.zeros(4, 5))
    # a uniform p(y|x) is the marginal: KL 0; the std is f32 roundoff of the sums
    assert abs(uniform.score() - 1.0) < 1e-6 and uniform.compute()[1] < 1e-3
    t.reset()
    assert t.stats is not None and float(t.stats.n) == 0
    with pytest.raises(RuntimeError) as jax_err:
        jis.InceptionScore().compute()
    with pytest.raises(RuntimeError) as port_err:
        tis.InceptionScore().compute()
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------ InceptionV3
@pytest.mark.parametrize("variant,size", [("fid", 75), ("fid", 299), ("torchvision", 75),
                                          ("torchvision", 299)])
def test_inception_v3_matches_jax(carried, variant, size):
    params, model, apply = carried[variant]
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    feats_j, logits_j = apply(params, x)
    with torch.no_grad():
        feats_t, logits_t = model(torch.from_numpy(x))
    assert feats_t.shape == (2, 2048) and logits_t.shape == (2, 1008 if variant == "fid" else 1000)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), **FEAT_TOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **FEAT_TOL)
    assert float(feats_t.abs().mean()) > 1e-2  # the drawn weights keep a signal to compare


@pytest.mark.parametrize("variant", VARIANTS)
def test_inception_parameter_names_and_counts_are_jax_tree(variant):
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), _shapes(variant))
    want = {k: tuple(v.shape) for k, v in from_flax(zeros).items()}
    got = {k: tuple(v.shape) for k, v in tinc.InceptionV3(variant=variant).state_dict().items()}
    assert got == want
    assert (sum(int(np.prod(s)) for s in got.values())
            == sum(x.size for x in jax.tree.leaves(zeros)))
    partial = from_flax(zeros)
    del partial["Mixed_7c.branch_pool.Conv_0.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        tinc.InceptionV3(variant=variant).load_state_dict(partial, strict=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_load_torch_weights_matches_twin_and_jax(twin, carried, variant):
    tm, path = twin[variant]
    _, _, apply = carried[variant]
    model = tinc.load_torch_weights(tinc.InceptionV3(variant=variant), path).eval()
    jparams = jinc.load_torch_weights(_shapes(variant), path)
    want_sd = from_flax(jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        feats_t, logits_t = model(torch.from_numpy(x))
        feats_w, logits_w = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    feats_j, logits_j = apply(jparams, x)
    for got, want in ((feats_t, feats_w), (logits_t, logits_w)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FEAT_TOL)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), **FEAT_TOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **FEAT_TOL)


def test_load_torch_weights_ignores_aux_logits_and_is_strict(twin, tmp_path):
    tm, path = twin["torchvision"]
    sd = torch.load(path, weights_only=True)
    want = tinc.load_torch_weights(tinc.InceptionV3(variant="torchvision"), path).state_dict()
    aux = dict(sd)  # torchvision's file carries its training head
    aux["AuxLogits.conv0.conv.weight"] = torch.randn(128, 768, 1, 1)
    for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
        aux[f"AuxLogits.conv0.bn.{name}"] = torch.full((128,), value)
    aux["AuxLogits.fc.weight"], aux["AuxLogits.fc.bias"] = torch.randn(1000, 768), torch.zeros(1000)
    torch.save(aux, tmp_path / "aux.pth")
    got = tinc.load_torch_weights(tinc.InceptionV3(variant="torchvision"),
                                  str(tmp_path / "aux.pth")).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    missing = {k: v for k, v in sd.items() if not k.startswith("Mixed_6b.branch7x7_2.conv.")}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key.*Mixed_6b.branch7x7_2.Conv_0"):
        tinc.load_torch_weights(tinc.InceptionV3(variant="torchvision"),
                                str(tmp_path / "missing.pth"))
    no_bn = {k: v for k, v in sd.items() if k != "Mixed_5b.branch_pool.bn.running_var"}
    torch.save(no_bn, tmp_path / "no_bn.pth")
    with pytest.raises(KeyError, match="Mixed_5b.branch_pool.bn.running_var"):
        tinc.load_torch_weights(tinc.InceptionV3(variant="torchvision"),
                                str(tmp_path / "no_bn.pth"))


def test_npz_both_ways_and_detect_variant(twin, carried, tmp_path):
    params, model, _ = carried["fid"]
    tinc.save_npz(model, str(tmp_path / "port.npz"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jinc.load_npz(str(tmp_path / "port.npz")), params)
    jinc.save_npz(params, str(tmp_path / "jax.npz"))
    sd = tinc.load_npz(str(tmp_path / "jax.npz"))
    assert sd.keys() == model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    tv = tinc.InceptionV3(variant="torchvision")
    tinc.save_npz(tv, str(tmp_path / "tv.npz"))
    for path in (twin["fid"][1], twin["torchvision"][1], str(tmp_path / "port.npz"),
                 str(tmp_path / "tv.npz")):
        assert tinc.detect_variant(path) == jinc.detect_variant(path)
    assert tinc.detect_variant(str(tmp_path / "port.npz")) == ("fid", 1008)
    assert tinc.detect_variant(twin["torchvision"][1]) == ("torchvision", 1000)


@pytest.mark.parametrize("size,atol", [(32, 1e-5), (299, 0.0), (320, 5e-5)])
def test_preprocess_matches_jax(size, atol):
    """Upscaled, unchanged and antialiased downscaled. Both packages compute
    the shrinking filter's weights in f32 from source coordinates up to 320
    (ulp 3.1e-5): there they differ by at most 2.5e-5, 8.5e-8 on average."""
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jinc.preprocess(jnp.asarray(x)))
    got = tinc.preprocess(torch.from_numpy(x))
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


def test_feature_fn_reads_every_weights_kind(twin, tmp_path):
    tm, path = twin["fid"]
    x01 = np.random.default_rng(11).uniform(0, 1, (2, 299, 299, 3)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x01 * 2 - 1).permute(0, 3, 1, 2))
    tinc.save_npz(tinc.load_torch_weights(tinc.InceptionV3(), path), str(tmp_path / "w.npz"))
    for weights in (path, str(tmp_path / "w.npz")):
        got = tinc.make_feature_fn(weights, device="cpu")(x01)
        assert not got[0].requires_grad
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **FEAT_TOL)
    # without weights: the FID topology, initialised from a seed (the same every time)
    feats, logits = tinc.make_feature_fn(device="cpu")(x01)
    again = tinc.make_feature_fn(device="cpu")(x01)
    assert logits.shape == (2, 1008)
    assert torch.equal(feats, again[0]) and torch.equal(logits, again[1])


def test_eval_runs_without_tf32_and_restores_the_callers_flags():
    """The feature function and the statistics product turn TF32 off in
    their scope only (PyTorch's default lets cuDNN convolutions use it)."""
    from dmme_tpu_torch.utils.device import ieee_f32

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with ieee_f32():
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        tfid.FeatureStats.create(4).update(torch.ones(2, 4))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ------------------------------------------------------------------- test()
class _JaxStubAlgo:
    """Generation stand-in: uniform images from the batch's key."""

    @staticmethod
    def generate(model_fn, params, rng, shape):
        return jax.random.uniform(rng, shape, minval=-1.0, maxval=1.0)


class _TorchStubAlgo:
    """The same images in the port: JAX's key of call k = batch k."""

    def __init__(self, seed):
        self.seed, self.calls = seed, 0

    def generate(self, model_fn, params, generator, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), self.calls)
        self.calls += 1
        return torch.from_numpy(np.asarray(
            jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)))


def _identity(x):
    return x


def _jax_model_fn(params, x, t):
    return x


def _stub_harnesses(seed):
    state = types.SimpleNamespace(params={}, ema_params={})
    jlit = types.SimpleNamespace(diffusion_model=_JaxStubAlgo(), model_fn=_jax_model_fn,
                                 sample_space_shape=tuple, to_images=_identity)
    tlit = types.SimpleNamespace(diffusion_model=_TorchStubAlgo(seed), num_classes=None,
                                 sampling_model_fn=lambda g, n, y: (None, g),
                                 sample_space_shape=tuple, to_images=_identity)
    return state, jlit, tlit


def test_test_loop_matches_jax_on_shared_images(twin, monkeypatch, tmp_path):
    """JAX's ``test()`` and the port's on the same images and weights: the
    keys, the counts, the Inception Score and the real means agree within
    1e-5. Three results are f32 cancellations of JAX's closed forms, held at
    what two accumulation orders leave of them:

    * Σ = (Σxxᵀ − n μμᵀ)/(n − 1) from f32 sums, where |μ|²/σ² ≈ 3e3 on these
      features: 3.5e-4 relative L2 measured, held within 2e-3;
    * the FID of 8 samples a side: rank-7 covariances in 2048 dimensions, so
      ~2,000 roundoff eigenvalues enter the square root (the self-FID of 8
      images reads −0.04 at tr Σ = 36; −4.5e-5 from f64 sums): 7.2e-5
      relative measured, held within 1e-3;
    * the IS std, √(E[h²] − E[h]²) of the per-sample entropy h with
      E[h]²/Var h ≈ 2e4: 9.2e-5 relative measured, held within 1e-3."""
    _, path = twin["fid"]
    monkeypatch.setattr(jevaluate, "make_feature_fn", _jax_feature_fn)
    seed = 5
    state, jlit, tlit = _stub_harnesses(seed)
    stats = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port")}
    kw = dict(seed=seed, max_batches=2, inception_weights=path, state=state)
    want = jevaluate.test(jlit, JaxCIFAR10(synthetic=True, synthetic_size=8, batch_size=4),
                          save_fid_stats=stats["jax"], **kw)
    got = tevaluate.test(tlit, CIFAR10(synthetic=True, synthetic_size=8, batch_size=4),
                         save_fid_stats=stats["port"], device="cpu", **kw)
    assert set(got) == set(want) == RESULT_KEYS and tlit.diffusion_model.calls == 2
    assert {k: got[k] for k in ("num_batches", "use_ema", "sampler", "sample_steps")} == {
        "num_batches": 2, "use_ema": True, "sampler": "default", "sample_steps": None}
    assert all(got[k] == want[k] for k in ("num_batches", "use_ema", "sampler", "sample_steps"))
    _close(got["inception_score"], float(want["inception_score"]), TEST_RTOL)
    _close(got["inception_score_std"], float(want["inception_score_std"]), F32_CANCEL_RTOL)
    jd, td = np.load(stats["jax"]), np.load(stats["port"])
    assert _rel_l2(td["mu"], jd["mu"]) < TEST_RTOL
    assert _rel_l2(td["sigma"], jd["sigma"]) < 2 * F32_CANCEL_RTOL
    _close(got["fid"], float(want["fid"]), F32_CANCEL_RTOL)


def _tiny_ddim(**kw):
    return LitDDIM(warmup=10, timesteps=10, sample_steps=4, dtype="f32",
                   model=t_ddpm.UNet(dtype=torch.float32, **TINY_UNET, **kw.pop("unet", {})),
                   **kw)


def _recorded_feature_fn(monkeypatch):
    """Wrap ``make_feature_fn`` so the images test() scores are kept."""
    seen = []
    real = teval.make_feature_fn

    def make(*args, **kwargs):
        fn = real(*args, **kwargs)

        def feature_fn(images):
            seen.append(images.clone())
            return fn(images)

        return feature_fn

    monkeypatch.setattr(teval, "make_feature_fn", make)
    return seen


@pytest.mark.parametrize("labelled", [False, True])
def test_test_draws_labels_first_then_generates_and_is_deterministic(monkeypatch, labelled):
    """Batch i of a class-conditional model guides on the batch's labels, or
    on labels drawn first from batch i's generator, then generates from it:
    what ``lit.generate`` does with that generator."""
    lit = _tiny_ddim(num_classes=10, guidance_scale=2.0, unet=dict(num_classes=10))
    state = lit.init_state(3, device="cpu")
    seen = _recorded_feature_fn(monkeypatch)
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=2, with_labels=labelled)
    kw = dict(seed=9, max_batches=2, state=state, device="cpu")
    first = tevaluate.test(lit, data, **kw)
    assert set(first) == RESULT_KEYS | {"warning"} and first["num_batches"] == 2
    if not labelled:  # deterministic
        assert first == tevaluate.test(lit, data, **kw)
    data.setup("test")
    for i in range(2):
        real, fake = seen[2 * i], seen[2 * i + 1]
        np.testing.assert_array_equal(
            real.numpy(), data.test_data[2 * i: 2 * i + 2].astype(np.float32) / np.float32(255))
        y = (torch.as_tensor(data.test_labels[2 * i: 2 * i + 2], dtype=torch.long)
             if labelled else None)
        want = denorm(lit.generate(state, step_generator(9, i, "cpu"), (2, 32, 32, 3), y=y))
        torch.testing.assert_close(fake, want, rtol=0, atol=0)


def test_test_samples_the_full_grid_of_an_iddpm_with_sample_steps(monkeypatch):
    """The JAX package's test() runs ``lit.diffusion_model`` (all T steps),
    not ``generate``'s ``sample_steps``-step strided grid."""
    lit = LitIDDPM(warmup=10, timesteps=6, sample_steps=2, dtype="f32",
                   model=t_iddpm.UNet(dtype=torch.float32, **TINY_UNET))
    state = lit.init_state(0, device="cpu")
    calls = []
    model_fn = lit.model_fn

    def counting(*args, **kwargs):
        calls.append(1)
        return model_fn(*args, **kwargs)

    monkeypatch.setattr(lit, "model_fn", counting)
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=4)
    out = tevaluate.test(lit, data, max_batches=1, state=state, device="cpu")
    assert len(calls) == 6 and out["num_batches"] == 1
    calls.clear()
    lit.generate(state, step_generator(0, 0, "cpu"), (4, 32, 32, 3))
    assert len(calls) == 2


def _guard_cases():
    ddim = dict(lit=lambda: _tiny_ddim())
    return [
        ("upsampler", dict(lit=lambda: LitUpsampler(factor=2, dtype="f32", model=t_ddpm.UNet(
            in_channels=6, out_channels=3, dtype=torch.float32, **TINY_UNET))), ValueError,
         "test has no conditioning source for a conditioned-input model"),
        ("vae", dict(lit=lambda: LitVAE(model=ConvVAE(latent_channels=4, base_channels=8,
                                                      channel_multipliers=(1, 2),
                                                      num_res_blocks=1))),
         ValueError, "evaluate() scores diffusion harnesses; LitVAE has no sampler"),
        ("sample_steps", dict(ddim, sample_steps=5), ValueError,
         "sample_steps without sampler would be silently ignored"),
        ("cached", dict(ddim, sampler="cached"), ValueError,
         "unknown sampler 'cached' (ddim|dpm|edm|unipc|flow)"),
        ("deep", dict(ddim, sampler="deep"), ValueError,
         "unknown sampler 'deep' (ddim|dpm|edm|unipc|flow)"),
        ("deep_dpm", dict(ddim, sampler="deep_dpm"), ValueError,
         "unknown sampler 'deep_dpm' (ddim|dpm|edm|unipc|flow)"),
        ("mesh", dict(ddim, mesh={"data": -1}), NotImplementedError,
         "test(mesh=...) is not ported yet (ROADMAP A.11"),
    ]


@pytest.mark.parametrize("case", _guard_cases(), ids=lambda c: c[0])
def test_test_guards_raise_jax_messages(case):
    name, kw, exc, message = case
    lit = kw.pop("lit")()
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=4)
    with pytest.raises(exc) as err:
        tevaluate.test(lit, data, device="cpu", **kw)
    assert message in str(err.value)
    if kw.get("sampler"):  # JAX's test() refuses it through this message
        with pytest.raises(ValueError) as jax_err:
            jax_make_sampler(JaxDDIM.create(10, 4), kw["sampler"])
        assert str(err.value) == str(jax_err.value)


TINY_CLI = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 2
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitDDIM
  init_args:
    warmup: 10
    timesteps: 10
    sample_steps: 4
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8, 8],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 8, batch_size: 4}}
"""


def test_trainer_test_runbook_chain(twin, tmp_path, capsys):
    """fit, then ``test`` with a weights file saving the real statistics,
    then ``test`` reading them: the same FID, no warning."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY_CLI.format(root=tmp_path / "run"))
    main(["fit", "--config", str(cfg)], device="cpu")
    capsys.readouterr()
    stats = str(tmp_path / "real.npz")
    common = ["test", "--config", str(cfg), "--trainer.inception_weights", twin["fid"][1],
              "--trainer.limit_test_batches", "2"]
    main(common + ["--trainer.save_fid_stats", stats], device="cpu")
    first = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(first) == RESULT_KEYS and np.isfinite(first["fid"]) and first["num_batches"] == 2
    assert os.path.exists(stats)
    main(common + ["--trainer.fid_stats", stats], device="cpu")
    second = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(second) == RESULT_KEYS
    _close(second["fid"], first["fid"], METRIC_RTOL)
    with pytest.raises(ValueError, match=r"unknown sampler 'cached' \(ddim\|dpm\|edm"):
        main(["test", "--config", str(cfg), "--trainer.sampler", "cached"], device="cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        main(["test", "--config", str(cfg), "--trainer.mesh.data", "-1"], device="cpu")
    with pytest.raises(ValueError, match="test needs a diffusion harness; LitClassifier"):
        main(["test", "--config", os.path.join(ROOT, "configs/adm/cifar10_classifier.yaml")],
             device="cpu")


# ---------------------------------------------------------------- the FID tool
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


def _tool_fid(tool, capsys, argv, **kw):
    tool(argv, **kw)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("FID: ")
    return float(out.split()[-1])


def _both_tools(capsys, monkeypatch, argv):
    monkeypatch.setattr(jinc, "make_feature_fn", _jax_feature_fn)
    got = _tool_fid(fid_tool.main, capsys, argv, device="cpu")
    return got, _tool_fid(jax_fid_tool.main, capsys, argv)


@pytest.mark.parametrize("pair", [("a.npy", "a.npy"), ("a_png", "a_q.npy")])
def test_fid_tool_same_pixels_score_zero_as_jax(image_sets, twin, capsys, monkeypatch, pair):
    argv = [str(image_sets / p) for p in pair] + ["--batch-size", "4",
                                                  "--weights", twin["fid"][1]]
    got, want = _both_tools(capsys, monkeypatch, argv)
    assert abs(got) < SELF_FID_FLOOR and abs(got - want) < SELF_FID_FLOOR


def test_fid_tool_stats_files_give_the_analytic_fid(capsys, monkeypatch, tmp_path):
    d = 8
    rng = np.random.RandomState(3)
    mu1, mu2 = rng.rand(d), rng.rand(d)
    s1, s2 = rng.rand(d) + 0.5, rng.rand(d) + 0.5
    p1, p2 = str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")
    np.savez(p1, mu=mu1, sigma=np.diag(s1))
    np.savez(p2, mu=mu2, sigma=np.diag(s2))
    want = float(np.sum((mu1 - mu2) ** 2) + np.sum(s1 + s2 - 2 * np.sqrt(s1 * s2)))
    got, jax_got = _both_tools(capsys, monkeypatch, [p1, p2])
    assert got == pytest.approx(want, rel=1e-5) and got == jax_got


def test_fid_tool_save_stats_round_trips(image_sets, twin, capsys, monkeypatch, tmp_path):
    root = str(image_sets)
    weights = ["--batch-size", "4", "--weights", twin["fid"][1]]
    stats = str(tmp_path / "a_stats.npz")
    fid_tool.main([f"{root}/a.npy", "--save-stats", stats, *weights], device="cpu")
    capsys.readouterr()
    d = np.load(stats)
    assert d["mu"].shape == (2048,) and d["sigma"].shape == (2048, 2048)
    got, want = _both_tools(capsys, monkeypatch, [stats, f"{root}/b.npy", *weights])
    direct = _tool_fid(fid_tool.main, capsys, [f"{root}/a.npy", f"{root}/b.npy", *weights],
                       device="cpu")
    assert got == direct and got > 10 * SELF_FID_FLOOR
    _close(got, want, F32_CANCEL_RTOL)


def test_fid_tool_names_pil_when_it_is_missing(image_sets, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        next(fid_tool._iter_batches(str(image_sets / "a_png"), 4))
