"""The UNet's feature-capture entry points and the feature-caching samplers
(``cached``, ``deep``, ``deep_dpm``) against the JAX package, on the TINY UNet.

Both frameworks run the same seeded weights (``from_flax``) in f32 on the
CPU; outputs, captured features and whole trajectories are held within
rtol/atol 1e-4, as tests/test_torch_port_samplers.py holds the solvers.
The starting states are JAX's draws, handed over. At ``refresh_interval=1``
each caching sampler must equal the port's exact solver bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import dmme_tpu_torch.models.blocks as blocks
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import EDM as JaxEDM
from dmme_tpu.diffusion import IDDPM as JaxIDDPM
from dmme_tpu.diffusion.factory import make_module_sampler as jax_make_module_sampler
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu_torch.diffusion import DDPM, EDM, IDDPM, make_sampler
from dmme_tpu_torch.diffusion import CachedDDIM, DeepCachedDDIM, DeepCachedDPM
from dmme_tpu_torch.diffusion.factory import MODULE_SAMPLERS, make_module_sampler
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
SHAPE = (2, 8, 8, 3)
T = 20
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed=0):
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def nets():
    """(JAX module, JAX params, port module, state_dict) on the same weights."""
    jmodel = jax_ddpm.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.int32))
    params = _random_params(shapes, seed=7)
    tmodel = t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, tmodel, sd


def _inputs(seed):
    r = np.random.default_rng(seed)
    return r.standard_normal(SHAPE).astype(np.float32), r.integers(1, T, (SHAPE[0],))


def _port(tmodel, sd, x, t, **kw):
    with torch.no_grad():
        return functional_call(tmodel, sd, (torch.tensor(x), torch.tensor(t)), kw)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg, **TOL)


# ---------------------------------------------------------- feature capture

def test_return_features_and_cached_match_jax(nets):
    """The encoder state (h_bottom and every skip) of a full forward, then a
    decoder-only forward at another x and t on each side's own state."""
    jmodel, params, tmodel, sd = nets
    x, t = _inputs(0)
    jout, (jh, jskips) = jmodel.apply(params, x, t, return_features=True)
    out, (h, skips) = _port(tmodel, sd, x, t, return_features=True)
    _close(out, jout, "output")
    _close(h, jh, "h_bottom")
    assert len(skips) == len(jskips)
    for k, (s, js) in enumerate(zip(skips, jskips)):
        _close(s, js, f"skip {k}")
    assert torch.equal(out, _port(tmodel, sd, x, t))  # the same forward, features aside
    x2, t2 = _inputs(1)
    want = jmodel.apply(params, x2, t2, cached=(jh, jskips))
    got = _port(tmodel, sd, x2, t2, cached=(h, skips))
    _close(got, want, "decoder on the cache")
    assert not np.allclose(got.numpy(), np.asarray(jmodel.apply(params, x2, t2)), atol=1e-3)


@pytest.mark.parametrize("cache_depth", [1, 2, 3])
def test_deep_cache_matches_jax(nets, cache_depth):
    """``return_deep`` gives the output and the deep core's; ``deep_cache``
    then runs the shallow layers only, at another x and t."""
    jmodel, params, tmodel, sd = nets
    x, t = _inputs(2)
    jout, jdeep = jmodel.apply(params, x, t, cache_depth=cache_depth, return_deep=True)
    out, deep = _port(tmodel, sd, x, t, cache_depth=cache_depth, return_deep=True)
    _close(out, jout, "output")
    _close(deep, jdeep, "deep core")
    assert torch.equal(out, _port(tmodel, sd, x, t))
    x2, t2 = _inputs(3)
    want = jmodel.apply(params, x2, t2, cache_depth=cache_depth, deep_cache=jdeep)
    got = _port(tmodel, sd, x2, t2, cache_depth=cache_depth, deep_cache=deep)
    _close(got, want, "shallow layers on the cache")


@pytest.mark.parametrize("kwargs,needle", [
    (dict(cache_depth=1, cached="features"), "exclusive"),
    (dict(cache_depth=0, return_deep=True), "cache_depth must be in"),
    (dict(cache_depth=4, return_deep=True), "cache_depth must be in"),
    (dict(return_deep=True), "requires cache_depth"),
    (dict(deep_cache=torch.zeros(1)), "requires cache_depth"),
])
def test_feature_capture_rejects_bad_arguments(nets, kwargs, needle):
    *_, tmodel, sd = nets
    x, t = _inputs(4)
    if kwargs.get("cached") == "features":
        kwargs["cached"] = _port(tmodel, sd, x, t, return_features=True)[1]
    with pytest.raises(ValueError, match=needle):
        _port(tmodel, sd, x, t, **kwargs)


def test_later_forwards_leave_cached_tensors_alone(nets):
    """The caches hold outputs of earlier forwards across later ones: no
    later forward, full or partial, may write into them."""
    *_, tmodel, sd = nets
    x, t = _inputs(5)
    _, feats = _port(tmodel, sd, x, t, return_features=True)
    _, deep = _port(tmodel, sd, x, t, cache_depth=1, return_deep=True)
    kept = [feats[0], *feats[1], deep]
    copies = [k.clone() for k in kept]
    for seed in (6, 7):
        x2, t2 = _inputs(seed)
        outs = [_port(tmodel, sd, x2, t2, cached=feats),
                _port(tmodel, sd, x2, t2, cache_depth=1, deep_cache=deep),
                *_port(tmodel, sd, x2, t2, return_features=True)[1][1],
                _port(tmodel, sd, x2, t2, cache_depth=1, return_deep=True)[1]]
        ptrs = {k.data_ptr() for k in kept}
        assert not any(o.data_ptr() in ptrs for o in outs)
    for k, (a, b) in enumerate(zip(kept, copies)):
        assert torch.equal(a, b), f"cached tensor {k} was overwritten"


def test_partial_forwards_call_the_kernels_the_topology_says():
    """At the DDPM UNet's full widths (channels 128/256/256/256, 2 blocks a
    depth, attention at depth 2; an 8×8 input keeps it cheap here), the calls
    of K1 (GroupNorm+SiLU), K3 (attention) and K4 (fused ResBlock) a forward:
    full 1/6/22; ``cached`` non-key (no down path: 8 ResBlocks, 2 with
    attention) 1/4/14; ``deep`` non-key at cache_depth 1 (2 shallow down and
    3 shallow up ResBlocks) 1/0/5."""
    model = t_ddpm.UNet(fused_norm=True, fused_block=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    x, t = torch.randn(1, 8, 8, 3), torch.tensor([500])
    names = {"group_norm_silu": "K1", "attention_heads": "K3", "resblock_forward": "K4"}
    calls = dict.fromkeys(names.values(), 0)
    originals = {n: getattr(blocks, n) for n in names}

    def counting(n):
        def fn(*a, **k):
            calls[names[n]] += 1
            return originals[n](*a, **k)
        return fn

    def count(**kw):
        calls.update(dict.fromkeys(calls, 0))
        with torch.no_grad():
            out = model(x, t, **kw)
        return dict(calls), out

    try:
        for n in names:
            setattr(blocks, n, counting(n))
        full, (_, feats) = count(return_features=True)
        _, (_, deep) = count(cache_depth=1, return_deep=True)
        cached, _ = count(cached=feats)
        deep_reuse, _ = count(cache_depth=1, deep_cache=deep)
    finally:
        for n, f in originals.items():
            setattr(blocks, n, f)
    assert full == {"K1": 1, "K3": 6, "K4": 22}
    assert cached == {"K1": 1, "K3": 4, "K4": 14}
    assert deep_reuse == {"K1": 1, "K3": 0, "K4": 5}


# ------------------------------------------------------------------ samplers

@pytest.fixture(scope="module")
def bases():
    return JaxDDPM.create(T), DDPM.create(T)


@pytest.mark.parametrize("name,steps,cache_depth", [("cached", 6, 1), ("deep", 6, 1),
                                                    ("deep", 5, 2), ("deep_dpm", 5, 1),
                                                    ("deep_dpm", 6, 3)])
def test_caching_sampler_matches_jax_at_interval_2(nets, bases, name, steps, cache_depth):
    jmodel, params, tmodel, sd = nets
    jbase, tbase = bases
    jalgo = jax_make_module_sampler(jbase, name, steps, refresh_interval=2,
                                    cache_depth=cache_depth)
    talgo = make_module_sampler(tbase, name, steps, refresh_interval=2, cache_depth=cache_depth)
    assert type(talgo).__name__ == type(jalgo).__name__
    np.testing.assert_array_equal(talgo.tau.numpy(), np.asarray(jalgo.tau))
    assert talgo.clip_x0 == jalgo.clip_x0 and talgo.sub_timesteps == steps
    rng = jax.random.PRNGKey(steps + cache_depth)
    want = jax.jit(lambda p, r: jalgo.generate(jmodel, p, r, SHAPE))(params, rng)
    key = jax.random.split(rng)[0] if name == "deep_dpm" else rng
    x_T = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    got = talgo.generate(tmodel, sd, None, SHAPE, x_T=torch.tensor(x_T))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("name,exact", [("cached", "ddim"), ("deep", "ddim"),
                                        ("deep_dpm", "dpm")])
def test_interval_one_is_the_exact_solver(nets, bases, name, exact):
    """Every step a key step: the port's DDIM (or DPM-Solver++(2M)) bit for
    bit, every frame."""
    *_, tmodel, sd = nets
    tbase = bases[1]
    algo = make_module_sampler(tbase, name, 6, refresh_interval=1)
    ref, _ = make_sampler(tbase, exact, 6)
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(3))

    def fn(p, x, t, **kw):
        return functional_call(tmodel, p, (x, t), kw)

    got, frames = algo.generate(tmodel, sd, None, SHAPE, x_T=x_T, history_length=6)
    want, want_frames = ref.generate(fn, sd, None, SHAPE, x_T=x_T, history_length=6)
    assert torch.equal(got, want) and torch.equal(frames, want_frames)


def test_interval_two_differs_from_the_exact_solver(nets, bases):
    *_, tmodel, sd = nets
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(4))
    outs = [make_module_sampler(bases[1], "deep", 6, refresh_interval=r).generate(
        tmodel, sd, None, SHAPE, x_T=x_T) for r in (1, 2)]
    assert not torch.allclose(*outs, atol=1e-4)


def test_module_samplers_draw_from_the_generator(nets, bases):
    *_, tmodel, sd = nets
    for name in MODULE_SAMPLERS:
        algo = make_module_sampler(bases[1], name, 4)
        a, b = (algo.generate(tmodel, sd, torch.Generator().manual_seed(1), SHAPE)
                for _ in range(2))
        assert torch.equal(a, b) and torch.isfinite(a).all()


def test_module_sampler_hyperparameters_match_jax(bases):
    """Default steps (50, 50, 20), τ, clip_x0 and the two knobs, on the
    linear and the cosine schedule."""
    cosine = (JaxDDPM.create(T).replace(schedule=JaxIDDPM.create(T).schedule),
              dataclasses.replace(DDPM.create(T), schedule=IDDPM.create(T).schedule))
    for jbase, tbase in (bases, cosine):
        for name in MODULE_SAMPLERS:
            jalgo = jax_make_module_sampler(jbase, name, None, refresh_interval=3,
                                            cache_depth=2)
            talgo = make_module_sampler(tbase, name, None, refresh_interval=3, cache_depth=2)
            assert type(talgo).__name__ == type(jalgo).__name__
            assert talgo.sub_timesteps == jalgo.sub_timesteps
            np.testing.assert_array_equal(talgo.tau.numpy(), np.asarray(jalgo.tau))
            assert talgo.clip_x0 == jalgo.clip_x0
            assert talgo.refresh_interval == jalgo.refresh_interval == 3
            if name != "cached":
                assert talgo.cache_depth == jalgo.cache_depth == 2
    assert isinstance(make_module_sampler(bases[1], "cached"), CachedDDIM)
    assert isinstance(make_module_sampler(bases[1], "deep"), DeepCachedDDIM)
    assert isinstance(make_module_sampler(bases[1], "deep_dpm"), DeepCachedDPM)


@pytest.mark.parametrize("case", ["conditional", "iddpm", "no_schedule"])
def test_make_module_sampler_rejections_match_jax(case):
    jbase, tbase, kw = {
        "conditional": (JaxDDPM.create(T), DDPM.create(T), dict(conditional=True)),
        "iddpm": (JaxIDDPM.create(T), IDDPM.create(T), {}),
        "no_schedule": (JaxEDM.create(), EDM.create(), {}),
    }[case]
    for name in MODULE_SAMPLERS:
        with pytest.raises(ValueError) as jerr:
            jax_make_module_sampler(jbase, name, **kw)
        with pytest.raises(ValueError) as terr:
            make_module_sampler(tbase, name, **kw)
        assert str(terr.value) == str(jerr.value)


def test_refresh_interval_must_be_positive(nets, bases):
    *_, tmodel, sd = nets
    algo = make_module_sampler(bases[1], "cached", 4, refresh_interval=0)
    with pytest.raises(ValueError, match="refresh_interval"):
        algo.generate(tmodel, sd, torch.Generator().manual_seed(0), SHAPE)
