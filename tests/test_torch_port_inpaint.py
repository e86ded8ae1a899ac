"""The port's RePaint ``inpaint`` against the JAX package's.

The TINY UNet (DDPM's ε head, and IDDPM's ε ‖ v head on its cosine
schedule) runs in f32 in both frameworks on the same seeded weights
(``from_flax``). JAX runs its real jitted ``inpaint`` scan; the port gets
JAX's draws through ``x_T`` and ``draws``: x_T = normal(split(rng)[0]), and
per timestep t and repeat u the three of ``split(fold_in(fold_in(scan_key,
t), u), 3)``, as tests/test_torch_port_sampling.py injects the ancestral
sampler's. The samples agree within rtol/atol 1e-4, and the known pixels
come back bit for bit (ᾱ₀ is exactly 1 in the port's tables).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import IDDPM as JaxIDDPM
from dmme_tpu.diffusion import inpaint as jax_inpaint
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu_torch.diffusion import DDPM, IDDPM, inpaint
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16),
            num_blocks=1, dropout=0.0, attention_depths=(2,))
SHAPE = (2, 8, 8, 3)
T = 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed):
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


@pytest.fixture(scope="module", params=["ddpm", "iddpm"])
def setup(request):
    """(name, JAX algo, JAX model_fn, params, port algo, port model_fn, state_dict)."""
    jax_lib, t_lib, jalgo, talgo = {
        "ddpm": (jax_ddpm, t_ddpm, JaxDDPM.create(timesteps=T), DDPM.create(timesteps=T)),
        "iddpm": (jax_iddpm, t_iddpm, JaxIDDPM.create(timesteps=T), IDDPM.create(timesteps=T)),
    }[request.param]
    jmodel = jax_lib.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.int32))
    params = _random_params(shapes, seed=3)
    if request.param == "iddpm":  # the variance head near v ≈ 0.5: variances inside [β̃, β]
        out = params["params"]["output_conv"]
        out["kernel"][..., 3:] *= 0.01
        out["bias"][3:] = 0.5
    tmodel = t_lib.UNet(**TINY, fused_norm=True, fused_block=True).eval()
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)

    def tfn(p, x, t, **kw):
        return torch.func.functional_call(tmodel, p, (x, t), kw)

    return request.param, jalgo, as_model_fn(jmodel), params, talgo, tfn, sd


def _known_and_mask():
    known = np.tile(np.linspace(-0.5, 0.5, SHAPE[2], dtype=np.float32)[None, None, :, None],
                    (SHAPE[0], SHAPE[1], 1, SHAPE[3]))
    mask = np.zeros((1,) + SHAPE[1:3] + (1,), np.float32)
    mask[:, :, : SHAPE[2] // 2] = 1.0  # the left half is known
    return known, mask


def _jax_draws(rng):
    """JAX's x_T and its per-(t, u) draws, as ``inpaint`` makes them."""
    x_key, scan_key = jax.random.split(rng)

    def normal(k):
        return torch.tensor(np.asarray(jax.random.normal(k, SHAPE, jnp.float32)))

    def draws(t, u):
        key = jax.random.fold_in(jax.random.fold_in(scan_key, t), u)
        return tuple(normal(k) for k in jax.random.split(key, 3))

    return normal(x_key), draws


@pytest.mark.parametrize("resample_steps", [1, 2])
def test_inpaint_matches_jax(setup, resample_steps):
    """The port's samples equal JAX's on JAX's draws; the known half is
    restored exactly, the generated half is generated."""
    name, jalgo, jfn, params, talgo, tfn, sd = setup
    known, mask = _known_and_mask()
    rng = jax.random.PRNGKey(5 + resample_steps)
    want = np.asarray(jax.jit(lambda p, r: jax_inpaint(
        jalgo, jfn, p, r, known=jnp.asarray(known), mask=jnp.asarray(mask),
        resample_steps=resample_steps))(params, rng))
    x_T, draws = _jax_draws(rng)
    got = inpaint(talgo, tfn, sd, None, torch.tensor(known), torch.tensor(mask),
                  resample_steps=resample_steps, x_T=x_T, draws=draws)
    assert got.shape == SHAPE and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    half = SHAPE[2] // 2
    assert torch.equal(got[:, :, :half], torch.tensor(known)[:, :, :half]), name
    assert float((got[:, :, half:] - torch.tensor(known)[:, :, half:]).abs().max()) > 0.05


def test_generator_draws_and_known_content_conditions(setup):
    """Drawing from a generator: repeatable for a seed, the known region
    exact, and a different known image changes the generated region too
    (the model sees the composite at every step); ``resample_steps`` 2
    changes the generated region and not the known one."""
    name, _, _, _, talgo, tfn, sd = setup
    known, mask = _known_and_mask()
    known, mask = torch.tensor(known), torch.tensor(mask)
    half = SHAPE[2] // 2

    def run(k, seed=0, r=1):
        return inpaint(talgo, tfn, sd, torch.Generator().manual_seed(seed), k, mask,
                       resample_steps=r)

    a, b = run(known), run(known)
    assert torch.equal(a, b) and torch.equal(a[:, :, :half], known[:, :, :half])
    other = run(-known)
    assert float((a[:, :, half:] - other[:, :, half:]).abs().max()) > 1e-3
    two = run(known, r=2)
    assert torch.equal(two[:, :, :half], known[:, :, :half])
    assert float((a[:, :, half:] - two[:, :, half:]).abs().max()) > 1e-4
