"""The port's UNet against the JAX package's, on the same weights.

The JAX parameters go through ``from_flax`` into the port's module with
``strict=True``; both run an eval-mode forward in f32 on the same inputs,
under each switch setting. On the CPU the JAX side takes its exact XLA
paths and the port its plain versions. Tolerance: rtol 1e-4 / atol 1e-5 on
outputs of unit scale (f32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models.blocks import sinusoidal_position_embedding as jax_sinusoidal
from dmme_tpu.models.unet import build_topology as jax_build_topology
from dmme_tpu_torch.models import build_topology, init_weights
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models.blocks import sinusoidal_position_embedding
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 32),
            num_blocks=2)
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 16, 16, 3)

SWITCHES = {
    "neither": dict(fused_norm=False, fused_block=False),
    "fused_norm": dict(fused_norm=True, fused_block=False),
    "both": dict(fused_norm=True, fused_block=True),
}


@pytest.fixture(scope="module")
def jax_params():
    model = jax_ddpm.UNet(**TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                                 jnp.zeros((2,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_params_random_affines(jax_params):
    """The flax init with every bias and GroupNorm scale redrawn from a seed
    (bias 0.1·N(0, 1), scale 1 + 0.1·N(0, 1)), so that each is wired where
    a zero or a one would hide it."""
    r = np.random.default_rng(1)

    def fill(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, jax_params)


def _inputs():
    r = np.random.default_rng(0)
    return r.standard_normal(SHAPE).astype(np.float32), np.array([3, 917], np.int32)


@pytest.mark.parametrize(
    "cpd,nb,attn",
    [((128, 256, 256, 256), 2, (2,)), ((4, 8, 16, 32), 2, (2,)), ((64, 128), 1, (1, 2)),
     ((8, 8, 8), 3, ())],
)
def test_build_topology_matches(cpd, nb, attn):
    got = build_topology(cpd, nb, attn)
    want = jax_build_topology(cpd, nb, attn)
    for g, w in zip(got, want):
        assert [(s.kind, s.c_out, s.attention, s.depth) for s in g] == [
            (s.kind, s.c_out, s.attention, s.depth) for s in w]


def test_sinusoidal_embedding_matches():
    t = np.array([0, 1, 500, 999], np.int32)
    got = sinusoidal_position_embedding(torch.tensor(t), 128)
    want = jax_sinusoidal(jnp.asarray(t), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-4)


def test_from_flax_loads_strict(jax_params):
    sd = from_flax(jax_params)
    model = t_ddpm.UNet(**TINY)
    model.load_state_dict(sd, strict=True)
    # the converter transposes, so the loaded tensors differ from the raw arrays' layout
    k = jax_params["params"]["down_0"]["conv1"]["kernel"]
    np.testing.assert_array_equal(model.down_0.conv1.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = jax_params["params"]["time_embed"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(model.time_embed.Dense_0.weight.detach().numpy(), d.T)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_forward_matches_jax(jax_params, switch):
    x, t = _inputs()
    jmodel = jax_ddpm.UNet(**TINY, **SWITCHES[switch])
    want = np.asarray(jax.jit(jmodel.apply)(jax_params, jnp.asarray(x), jnp.asarray(t)))
    model = t_ddpm.UNet(**TINY, **SWITCHES[switch])
    model.load_state_dict(from_flax(jax_params), strict=True)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(t, dtype=torch.int64)).numpy()
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_forward_matches_jax_with_random_affines(jax_params_random_affines, switch):
    params = jax_params_random_affines
    assert not np.all(params["params"]["down_0"]["conv1"]["bias"] == 0)
    x, t = _inputs()
    jmodel = jax_ddpm.UNet(**TINY, **SWITCHES[switch])
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    model = t_ddpm.UNet(**TINY, **SWITCHES[switch])
    model.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(t, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_switches_do_not_change_parameters():
    keys = {k: v.shape for k, v in t_ddpm.UNet(**TINY).state_dict().items()}
    for kw in SWITCHES.values():
        assert {k: v.shape for k, v in t_ddpm.UNet(**TINY, **kw).state_dict().items()} == keys


def test_full_width_parameters_match_jax_tree():
    """32,416,643 parameters, with the keys and shapes ``from_flax`` gives for
    the JAX tree (shapes from ``jax.eval_shape``: no forward runs)."""
    model = t_ddpm.UNet()
    assert sum(p.numel() for p in model.parameters()) == 32_416_643
    shapes = jax.eval_shape(
        jax_ddpm.UNet().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in from_flax(zeros).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_init_mirrors_flax_defaults():
    model = init_weights(t_ddpm.UNet(**TINY), torch.Generator().manual_seed(0))
    w = model.down_0.conv1.weight.detach()
    fan_in = w[0].numel()
    assert w.abs().max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert model.down_0.conv1.bias.abs().max() == 0
    assert torch.all(model.out_norm.weight == 1) and torch.all(model.out_norm.bias == 0)
    again = init_weights(t_ddpm.UNet(**TINY), torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.down_0.conv1.weight, model.down_0.conv1.weight,
                               rtol=0, atol=0)
