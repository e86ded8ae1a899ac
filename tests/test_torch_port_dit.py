"""The port's DiT against the JAX package's.

A tiny DiT (patch 4, hidden 32, depth 2, 2 heads, pos_dim 16) on 16×16
images runs in f32 in both frameworks on the same seeded numpy weights
(``from_flax``). Every weight is drawn, the zero-initialised adaLN-Zero
layers and the biases too: at flax's init a DiT outputs exactly 0 and a
comparison would read 0 against 0. Forwards and gradients agree within
rtol/atol 1e-4 (tests/test_torch_port_sampling.py's tolerance), dense and
MoE (4 experts in block 1), unconditional, class-conditional,
learned-variance and the upsampler's 2C input; ``remat`` is held bit for
bit against the plain forward on the same draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.models import dit as jax_dit
from dmme_tpu_torch.models import dit, init_weights
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(patch_size=4, hidden=32, depth=2, num_heads=2, pos_dim=16)
SHAPE = (2, 16, 16, 3)


def _random_params(shapes, seed):
    """Seeded numpy values for every leaf: kernels and expert stacks of
    variance 1/fan_in (the zero-initialised ones too), embeddings N(0, 1),
    biases 0.1·N(0, 1)."""
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "w_in", "w_out"):
            fan_in = np.prod(leaf.shape[:-1]) if name == "kernel" else leaf.shape[-2]
            v = r.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif name == "embedding":
            v = r.standard_normal(leaf.shape)
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(seed=0, x_shape=SHAPE, **kw):
    """(JAX module, numpy params, port module) on the same weights."""
    cfg = dict(TINY, **kw)
    jmodel = jax_dit.DiT(**cfg)
    y = jnp.zeros((x_shape[0],), jnp.int32) if cfg.get("num_classes") else None
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros(x_shape),
                                                  jnp.zeros((x_shape[0],), jnp.int32), y=y),
                            jax.random.PRNGKey(0))
    params = _random_params(shapes["params"], seed)
    tmodel = DiT(**cfg)
    tmodel.load_state_dict(from_flax(params), strict=True)
    return jmodel, params, tmodel


def _inputs(seed, x_shape=SHAPE, num_classes=None):
    r = np.random.default_rng(seed)
    x = r.standard_normal(x_shape).astype(np.float32)
    t = np.array([3, 731], np.int32)[: x_shape[0]]
    y = None if num_classes is None else r.integers(0, num_classes + 1, x_shape[0]).astype(np.int32)
    return x, t, y


CASES = {
    "dense": dict(),
    "conditional": dict(num_classes=3),
    "learned_variance": dict(out_channels=6),
    "upsampler_input": dict(in_channels=6, out_channels=3),
    "moe": dict(num_experts=4, moe_stride=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradient_match_jax(case):
    """Eval forward and the gradient of mean((out − target)²) w.r.t. every
    parameter, against JAX's, per case."""
    kw = CASES[case]
    x_shape = SHAPE[:3] + (kw.get("in_channels", 3),)
    jmodel, params, tmodel = _pair(seed=1, x_shape=x_shape, **kw)
    x, t, y = _inputs(2, x_shape, kw.get("num_classes"))
    out_ch = kw.get("out_channels", 3)
    target = np.random.default_rng(3).standard_normal(SHAPE[:3] + (out_ch,)).astype(np.float32)
    jy = None if y is None else jnp.asarray(y)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), y=jy)
        return jnp.mean(jnp.square(out - target)), out

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    tparams = {k: v.detach().requires_grad_(True) for k, v in tmodel.state_dict().items()}
    tout = torch.func.functional_call(
        tmodel, tparams, (torch.tensor(x), torch.tensor(t)),
        {"y": None if y is None else torch.tensor(y)})
    assert tout.shape == SHAPE[:3] + (out_ch,) and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    tl = torch.mean(torch.square(tout - torch.tensor(target)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    grads = dict(zip(tparams, torch.autograd.grad(tl, list(tparams.values()))))
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_train_mode_moe_matches_jax():
    """Training mode with the routers' noise off: Sinkhorn-balanced routing
    and the router losses of block 1 as JAX sows them."""
    jmodel, params, tmodel = _pair(seed=4, num_experts=4, moe_stride=2, moe_router_noise=0.0)
    x, t, _ = _inputs(5)
    jout, vs = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["losses", "moe_stats"])
    stats = []
    with torch.no_grad():
        tout = tmodel(torch.tensor(x), torch.tensor(t), train=True, moe_losses=stats)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert len(stats) == 1
    for name, value in vs["losses"]["block_1"]["moe_mlp"].items():
        np.testing.assert_allclose(float(stats[0][name]), float(value[0]), err_msg=name, **TOL)
    np.testing.assert_array_equal(stats[0]["f_e"].numpy(),
                                  np.asarray(vs["moe_stats"]["block_1"]["moe_mlp"]["f_e"][0]))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_equals_plain(moe):
    """``remat`` recomputes each block in the backward on the draws of the
    first call (dropout 0.2, router noise): output, router losses and every
    gradient equal the plain model's bit for bit on the same generator."""
    kw = dict(dropout=0.2) if not moe else dict(num_experts=4, moe_stride=2)
    _, _, plain = _pair(seed=6, **kw)
    remat = DiT(**TINY, **kw, remat=True)
    remat.load_state_dict(plain.state_dict(), strict=True)
    x, t, _ = _inputs(7)
    results = []
    for model in (plain, remat):
        stats = []
        params = {k: v.detach().requires_grad_(True) for k, v in model.state_dict().items()}
        out = torch.func.functional_call(
            model, params, (torch.tensor(x), torch.tensor(t)),
            {"train": True, "generator": torch.Generator().manual_seed(11), "moe_losses": stats})
        loss = torch.mean(torch.square(out)) + sum(s["moe_aux"] + s["moe_z"] for s in stats)
        grads = torch.autograd.grad(loss, list(params.values()))
        results.append((out.detach(), [{k: v.detach() for k, v in s.items()} for s in stats],
                        dict(zip(params, grads))))
    (o1, s1, g1), (o2, s2, g2) = results
    assert torch.equal(o1, o2)
    assert len(s1) == len(s2) == (1 if moe else 0)
    for a, b in zip(s1, s2):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_zero_init_outputs_zero_and_float_timesteps():
    """adaLN-Zero: after ``init_weights`` the gates and the final projection
    are zero, so any input maps to exactly 0, float timesteps included."""
    model = DiT(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    for name in ("block_0.adaln_mod.weight", "final_mod.weight", "final_proj.weight"):
        assert float(model.state_dict()[name].abs().max()) == 0.0
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(x, torch.tensor([0.5, 731.2]))
    assert out.shape == SHAPE and torch.equal(out, torch.zeros(SHAPE))


def test_posemb_and_layer_norm_match_flax():
    """The sin-cos table ([sin x, cos x, sin y, cos y], ω over max(quarter − 1,
    1)) on non-square grids, and flax's scale-free LayerNorm: on inputs
    offset from zero, and on inputs of variance 1e-6, where flax's epsilon
    (1e-6, not torch's 1e-5) halves the output."""
    from flax import linen as fnn

    for gh, gw, d in ((4, 6, 32), (2, 2, 4), (8, 8, 384)):
        np.testing.assert_allclose(dit.posemb_sincos_2d(gh, gw, d).numpy(),
                                   np.asarray(jax_dit.posemb_sincos_2d(gh, gw, d)),
                                   rtol=1e-6, atol=1e-6)
    ln = fnn.LayerNorm(use_scale=False, use_bias=False)
    noise = np.random.default_rng(0).standard_normal((3, 5, 32))
    for x in (1.0 + noise, 1e-3 * noise):
        x = x.astype(np.float32)
        np.testing.assert_allclose(dit.layer_norm(torch.tensor(x), torch.float32).numpy(),
                                   np.asarray(ln.apply({}, jnp.asarray(x))), **TOL)


def test_parameter_counts_of_the_configs():
    """DiT-S/4 of configs/flow/cifar10_dit.yaml and its MoE variant of
    cifar10_dit_moe.yaml (8 experts in blocks 1, 3, …, 11), built on the
    meta device."""
    with torch.device("meta"):
        dense = dit.DiT_S()
        moe = DiT(num_experts=8, moe_stride=2, moe_top_k=2, moe_capacity_factor=1.25)
    assert sum(p.numel() for p in dense.parameters()) == 32_499_120
    assert sum(p.numel() for p in moe.parameters()) == 82_143_456
    assert [i for i in range(12) if getattr(moe, f"block_{i}").moe_mlp is not None] == \
        [1, 3, 5, 7, 9, 11]


def test_caching_samplers_refuse_a_dit():
    """``cached``, ``deep`` and ``deep_dpm`` drive the UNet's feature capture;
    a DiT is refused before any forward, naming it."""
    from dmme_tpu_torch.training import LitDDPM, TrainState

    model = DiT(**TINY)
    lit = LitDDPM(model=model, timesteps=10)
    calls = []
    model.register_forward_pre_hook(lambda *a: calls.append(1))
    state = TrainState.create({k: v.detach() for k, v in model.state_dict().items()},
                              lit.make_optimizer())
    for name in ("cached", "deep", "deep_dpm"):
        with pytest.raises(ValueError, match="feature capture"):
            lit.generate(state, torch.Generator().manual_seed(0), SHAPE, sampler=name,
                         steps=4)
    assert not calls


def test_dit_serves_iddpm_and_the_upsampler():
    """``DiT(out_channels=2C)`` is an IDDPM denoiser (ε ‖ v: the hybrid loss,
    the respaced sampler) and ``DiT(in_channels=2C)`` the upsampler's (x_t ‖
    the resized low-resolution image); both train a step's loss and sample
    on the CPU."""
    from dmme_tpu_torch.training import LitIDDPM, LitUpsampler

    x = torch.rand(SHAPE, generator=torch.Generator().manual_seed(2)) * 2 - 1
    for lit, kw in ((LitIDDPM(model=DiT(**TINY, out_channels=6), timesteps=10, sample_steps=4),
                     {"img_shape": SHAPE}),
                    (LitUpsampler(factor=2, model=DiT(**TINY, in_channels=6, out_channels=3),
                                  timesteps=10), {"low_res": x[:, ::2, ::2]})):
        state = lit.init_state(0, device="cpu")
        loss = lit.make_loss_fn()(state.params, torch.Generator().manual_seed(1), x)
        assert loss.dim() == 0 and bool(torch.isfinite(loss))
        kw = dict(kw)
        shape = kw.pop("img_shape", None)
        out = lit.generate(state, torch.Generator().manual_seed(3), shape, **kw)
        assert out.shape == SHAPE and bool(torch.isfinite(out).all())
