"""Evaluation in the port against the JAX package, part 1: the statistics
(``FeatureStats``, the Fréchet distance, FID, the Inception Score),
InceptionV3, its weight loaders and ``preprocess``.

Fixtures and tolerances come from tests/torch_port_eval_common.py: rtol 1e-4
/ atol 1e-5 for features and logits, 1e-6 relative for FID and IS on the
same features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.eval import fid as jfid
from dmme_tpu.eval import inception as jinc
from dmme_tpu.eval import inception_score as jis
from dmme_tpu_torch.eval import fid as tfid
from dmme_tpu_torch.eval import inception as tinc
from dmme_tpu_torch.eval import inception_score as tis
from dmme_tpu_torch.utils.convert import from_flax
from tests.torch_port_eval_common import (FEAT_TOL, METRIC_RTOL, VARIANTS, _close,  # noqa: F401
                                          _shapes, carried, twin)

torch.set_num_threads(1)


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
