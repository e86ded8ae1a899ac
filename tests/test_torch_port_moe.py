"""The port's ``MoEMlp`` against the JAX package's.

Both layers run in f32 on the same seeded numpy weights (``from_flax``, the
biases drawn too, since flax starts them at zero) and inputs. The expert
assignment is compared first, token by token, against a float64 numpy
routing of JAX's own router logits (read with ``capture_intermediates``),
with the smallest margin between a chosen score and the next one printed
on failure; then the output and the router losses within rtol/atol 1e-4,
as in tests/test_torch_port_sampling.py. Training mode feeds the port the
router noise JAX draws (``normal(make_rng("dropout"))`` of the root scope,
replayed by a probe module).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dmme_tpu.models.moe import MoEMlp as JaxMoEMlp
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.models.moe import MoEMlp
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
D, F_DIM = 8, 16


def _random_params(shapes, seed):
    """Seeded numpy values: kernels and expert stacks of variance 1/fan_in,
    biases 0.1·N(0, 1)."""
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "w_in", "w_out"):
            v = r.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class _NoiseProbe(fnn.Module):
    """The root scope's first ``make_rng("dropout")`` draw, as MoEMlp makes it."""

    shape: tuple

    @fnn.compact
    def __call__(self):
        return jax.random.normal(self.make_rng("dropout"), self.shape, jnp.float32)


def _pair(x_shape, seed, **kw):
    """(JAX layer, numpy params, port layer) with the same weights."""
    jlayer = JaxMoEMlp(mlp_dim=F_DIM, **kw)
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), jnp.zeros(x_shape))
    params = _random_params(shapes["params"], seed)
    tlayer = MoEMlp(x_shape[-1], kw["num_experts"], F_DIM,
                    **{k: v for k, v in kw.items() if k not in ("num_experts", "deterministic")})
    tlayer.load_state_dict(from_flax(params), strict=True)
    return jlayer, params, tlayer


def _numpy_assignment(logits, k, sinkhorn_iters):
    """Top-k choice of each token from float64 logits, and the smallest
    margin between a chosen score and the best one left behind."""
    z = logits - logits.max(-1, keepdims=True)
    sel = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    for _ in range(sinkhorn_iters):
        sel = sel / (sel.sum(0, keepdims=True) + 1e-9)
        sel = sel / (sel.sum(1, keepdims=True) + 1e-9)
    order = np.argsort(-sel, axis=-1, kind="stable")
    ranked = np.take_along_axis(sel, order, -1)
    return order[:, :k], float(np.min(ranked[:, k - 1] - ranked[:, k])) if k < sel.shape[1] \
        else np.inf


def _jax_apply(jlayer, params, x, noise_key=None):
    rngs = None if noise_key is None else {"dropout": noise_key}
    y, vs = jlayer.apply({"params": params}, jnp.asarray(x), rngs=rngs,
                         mutable=["losses", "moe_stats", "intermediates"],
                         capture_intermediates=True)
    return np.asarray(y), vs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("experts,top_k", [(4, 2), (4, 1)])
def test_moe_matches_jax(train, experts, top_k):
    """Eval (argmax of the raw softmax) and training (router noise from
    JAX's stream, 8 Sinkhorn rounds, the alignment loss) at ample capacity:
    assignment, output, ``moe_aux``/``moe_align``/``moe_z`` and ``f_e``."""
    x_shape = (2, 8, D)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    jlayer, params, tlayer = _pair(x_shape, seed=2, num_experts=experts, top_k=top_k,
                                   capacity_factor=2.0, deterministic=not train)
    key = jax.random.PRNGKey(7) if train else None
    want, vs = _jax_apply(jlayer, params, x, key)
    logits = np.asarray(vs["intermediates"]["router"]["__call__"][0], np.float64)
    noise = None
    if train:
        noise = np.asarray(_NoiseProbe((16, experts)).apply({}, rngs={"dropout": key}))
        logits = logits + noise
    chosen, margin = _numpy_assignment(logits, top_k, 8 if train else 0)

    xt = torch.tensor(x)
    with torch.no_grad():
        t_logits = tlayer.router(xt.reshape(16, D))
        if train:
            t_logits = t_logits + torch.tensor(noise)
        _, masks, _, _ = tlayer.route(t_logits, train)
        got_chosen = np.stack([m.argmax(-1).numpy() for m in masks], -1)
        np.testing.assert_array_equal(got_chosen, chosen,
                                      err_msg=f"assignment differs; smallest margin {margin:.3e}")
        y, stats = tlayer(xt, train=train,
                          noise=None if noise is None else torch.tensor(noise))
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    losses = {k: float(v[0]) for k, v in vs["losses"].items()}
    assert set(losses) == {"moe_aux", "moe_z"} | ({"moe_align"} if train else set())
    assert set(stats) == set(losses) | {"f_e"}
    for name, value in losses.items():
        np.testing.assert_allclose(float(stats[name]), value, err_msg=name, **TOL)
    np.testing.assert_array_equal(stats["f_e"].numpy(), np.asarray(vs["moe_stats"]["f_e"][0]))


def test_capacity_overflow_matches_jax():
    """16 tokens on 2 experts at capacity 1 (top-1): tokens past their
    expert's queue get zero output, as ``jax.nn.one_hot`` of an index out of
    range gives a zero row; the output equals JAX's everywhere."""
    x_shape = (1, 16, D)
    x = np.random.default_rng(3).standard_normal(x_shape).astype(np.float32)
    jlayer, params, tlayer = _pair(x_shape, seed=4, num_experts=2, top_k=1,
                                   capacity_factor=2 / 16)
    assert tlayer.capacity(16) == 1
    want, _ = _jax_apply(jlayer, params, x)
    with torch.no_grad():
        y, _ = tlayer(torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    active = (np.abs(y.numpy()[0]).sum(-1) > 0).sum()
    assert 1 <= active <= 2


def test_top2_overflow_queues_behind_round_one():
    """Top-2 at capacity factor 0.5: round-2 tokens queue behind round-1
    occupants and some overflow; the output still equals JAX's."""
    x_shape = (2, 8, D)
    x = np.random.default_rng(5).standard_normal(x_shape).astype(np.float32)
    jlayer, params, tlayer = _pair(x_shape, seed=6, num_experts=4, top_k=2,
                                   capacity_factor=0.5)
    want, _ = _jax_apply(jlayer, params, x)
    with torch.no_grad():
        y, _ = tlayer(torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), want, **TOL)


def test_router_gradient_matches_jax():
    """The gradient of Σy + aux + z w.r.t. every parameter in training mode
    (noise replayed), against ``jax.grad`` of the same function."""
    x_shape = (2, 8, D)
    x = np.random.default_rng(8).standard_normal(x_shape).astype(np.float32)
    jlayer, params, tlayer = _pair(x_shape, seed=9, num_experts=4, top_k=2,
                                   capacity_factor=2.0, deterministic=False)
    key = jax.random.PRNGKey(2)
    noise = np.asarray(_NoiseProbe((16, 4)).apply({}, rngs={"dropout": key}))

    def jloss(p):
        y, vs = jlayer.apply({"params": p}, jnp.asarray(x), rngs={"dropout": key},
                             mutable=["losses"])
        return jnp.sum(jnp.square(y)) + sum(v[0] for v in vs["losses"].values())

    want = from_flax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    y, stats = tlayer(torch.tensor(x), train=True, noise=torch.tensor(noise))
    loss = torch.sum(torch.square(y)) + stats["moe_aux"] + stats["moe_align"] + stats["moe_z"]
    grads = dict(zip([k for k, _ in tlayer.named_parameters()],
                     torch.autograd.grad(loss, list(tlayer.parameters()))))
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_expert_init_counts_the_expert_axis():
    """flax's ``lecun_normal`` on an (E, d, f) stack has fan-in E·d: std
    1/√(E·d) (0.01804 for (8, 384, 1536)); the biases start at zero."""
    layer = MoEMlp(384, 8, 1536)
    init_weights(layer, torch.Generator().manual_seed(0))
    sd = {k: v.detach() for k, v in layer.state_dict().items()}
    assert abs(float(sd["w_in"].std()) - (8 * 384) ** -0.5) < 2e-4
    assert abs(float(sd["w_out"].std()) - (8 * 1536) ** -0.5) < 2e-4
    assert float(sd["b_in"].abs().max()) == 0.0 and float(sd["b_out"].abs().max()) == 0.0
    jw = JaxMoEMlp(num_experts=8, mlp_dim=1536).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 4, 384)))["params"]["w_in"]
    assert abs(float(jnp.std(jw)) - float(sd["w_in"].std())) < 2e-4


# ------------------------------------------- the harnesses add the router losses

DIT = dict(patch_size=4, hidden=32, depth=2, num_heads=2, pos_dim=16, num_experts=4,
           moe_stride=2, moe_router_noise=0.0)
IMG = (2, 8, 8, 3)


class _FixedDraws:
    """A diffusion algorithm (or distiller) whose ``loss`` runs its
    ``loss_given`` on fixed draws, so that the two frameworks' harnesses see
    the same t (or i) and noise; the dropout stream is passed on."""

    def __init__(self, inner, draws, jax_side):
        self.inner, self.draws, self.jax_side = inner, draws, jax_side

    def _stream(self, rng):
        return {"dropout_rng": rng} if self.jax_side else {"generator": rng}

    def loss(self, *args, train=True):
        *fns, rng, x = args
        return self.inner.loss_given(*fns, x, *self.draws, train=train, **self._stream(rng))

    def to(self, device):
        return self


def _dits(seed, in_channels=3):
    from dmme_tpu.models import dit as jax_dit
    from dmme_tpu_torch.models.dit import DiT

    cfg = dict(DIT, in_channels=in_channels, out_channels=3)
    jmodel = jax_dit.DiT(**cfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros(IMG[:3] + (in_channels,)),
                                                  jnp.zeros((IMG[0],), jnp.int32)),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "w_in", "w_out"):
            fan_in = np.prod(leaf.shape[:-1]) if name == "kernel" else leaf.shape[-2]
            return (r.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    tmodel = DiT(**cfg)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, {"params": params}, tmodel, sd


def _harnesses(name, weight):
    """(JAX harness, port harness, JAX params, port params) of ``name`` on a
    tiny MoE DiT, at ``moe_aux_weight`` ``weight``, with fixed draws."""
    from dmme_tpu import training as jtr
    from dmme_tpu.diffusion.distill import ProgressiveDistillation as JaxPD
    from dmme_tpu_torch import training as ttr
    from dmme_tpu_torch.diffusion import ProgressiveDistillation

    r = np.random.default_rng(11)
    noise = r.standard_normal(IMG).astype(np.float32)
    jmodel, jp, tmodel, sd = _dits(12, in_channels=6 if name == "upsampler" else 3)
    if name == "distill":
        _, tjp, _, tsd = _dits(13)
        i = np.array([1, 2], np.int32)
        jlit = jtr.LitDistill(teacher_model=jmodel, teacher_params=tjp,
                              distiller=JaxPD.create(timesteps=8, student_steps=2),
                              moe_aux_weight=weight)
        tlit = ttr.LitDistill(teacher_model=tmodel, teacher_params=tsd,
                              distiller=ProgressiveDistillation.create(8, 2),
                              moe_aux_weight=weight)
        jlit.distiller = _FixedDraws(jlit.distiller, (jnp.asarray(i), jnp.asarray(noise)), True)
        tlit.distiller = _FixedDraws(tlit.distiller, (torch.tensor(i), torch.tensor(noise)),
                                     False)
        return jlit, tlit, jp, sd
    if name == "flow":
        t = np.array([0.3, 0.8], np.float32)
        jlit = jtr.LitFlow(model=jmodel, moe_aux_weight=weight)
        tlit = ttr.LitFlow(model=tmodel, moe_aux_weight=weight)
    elif name == "upsampler":
        t = np.array([2, 7], np.int32)
        jlit = jtr.LitUpsampler(factor=2, model=jmodel, timesteps=8, moe_aux_weight=weight)
        tlit = ttr.LitUpsampler(factor=2, model=tmodel, timesteps=8, moe_aux_weight=weight)
    else:
        t = np.array([2, 7], np.int32)
        jlit = jtr.LitDDPM(model=jmodel, timesteps=8, moe_aux_weight=weight)
        tlit = ttr.LitDDPM(model=tmodel, timesteps=8, moe_aux_weight=weight)
    jlit.diffusion_model = _FixedDraws(jlit.diffusion_model, (jnp.asarray(t), jnp.asarray(noise)),
                                       True)
    tlit.diffusion_model = _FixedDraws(tlit.diffusion_model, (torch.tensor(t),
                                                              torch.tensor(noise)), False)
    return jlit, tlit, jp, sd


@pytest.mark.parametrize("name", ["ddpm", "flow", "upsampler", "distill"])
def test_harness_adds_router_losses_as_jax(name):
    """Each harness's training loss on a tiny MoE DiT (training-mode routing,
    the routers' noise off) at ``moe_aux_weight`` 0.01 and 0, on the same
    draws, equals JAX's: ``loss + 0.01·Σ(aux + align) + 1e-3·Σ z`` where
    the weight is on, the plain loss where it is off (tests/test_moe.py's
    harness cases for LitFlow, LitDistill and LitUpsampler, here against
    JAX's numbers)."""
    x = np.random.default_rng(14).uniform(-1, 1, IMG).astype(np.float32)
    got = {}
    for weight in (0.01, 0.0):
        jlit, tlit, jp, sd = _harnesses(name, weight)
        want = float(jax.jit(jlit.make_loss_fn(None))(jp, jax.random.PRNGKey(0),
                                                      jnp.asarray(x)))
        with torch.no_grad():
            got[weight] = float(tlit.make_loss_fn(None)(sd, torch.Generator().manual_seed(0),
                                                        torch.tensor(x)))
        np.testing.assert_allclose(got[weight], want, err_msg=f"weight {weight}", **TOL)
    assert got[0.01] > got[0.0]


def test_eval_loss_adds_no_router_loss():
    """``eval_loss`` (the validate path) adds nothing at any weight, as JAX's."""
    x = np.random.default_rng(15).uniform(-1, 1, IMG).astype(np.float32)
    values = []
    for weight in (0.01, 0.0):
        jlit, tlit, jp, sd = _harnesses("ddpm", weight)
        want = float(jlit.eval_loss(jp, jax.random.PRNGKey(0), jnp.asarray(x)))
        values.append(float(tlit.eval_loss(sd, torch.Generator().manual_seed(0),
                                           torch.tensor(x))))
        np.testing.assert_allclose(values[-1], want, **TOL)
    assert values[0] == values[1]
