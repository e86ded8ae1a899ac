"""The port's equations against the JAX package's, on the same inputs.

τ tables are integer and must be equal. β/α/ᾱ agree within 1e-6 abs, not
bit for bit: ``torch.linspace`` and ``jnp.linspace`` differ by a few 1e-9,
and the cumulative products by up to a few 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmme_tpu.equations as jeq
from dmme_tpu_torch import equations as teq
from dmme_tpu_torch.utils import denorm, norm, pad

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["linear", "quadratic"])
@pytest.mark.parametrize("t,s", [(1000, 50), (1000, 10), (20, 10), (37, 7)])
def test_tau_tables_equal(name, t, s):
    got = teq.ddim.make_tau(name, t, s).numpy()
    want = np.asarray(jeq.ddim.make_tau(name, t, s))
    np.testing.assert_array_equal(got, want)


def test_quadratic_tau_is_degenerate_at_t1000_s50():
    assert int(teq.ddim.quadratic_tau(1000, 50)[1]) == 0


@pytest.mark.parametrize("t", [20, 1000])
def test_schedule_tables(t):
    tb = teq.ddpm.linear_schedule(t)
    jb = jeq.ddpm.linear_schedule(t)
    assert tb.shape == (t + 1,) and float(tb[0]) == 0.0
    ts, js = teq.ddpm.schedule_from_beta(tb), jeq.ddpm.schedule_from_beta(jb)
    for name in ("beta", "alpha", "alpha_bar"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def _inputs(seed=0, shape=(2, 4, 4, 3)):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_reverse_process_canonical_matches(eta):
    x, eps = _inputs()
    ab_t, ab_prev = np.float32(0.3), np.float32(0.6)
    got = teq.ddim.reverse_process_canonical(torch.tensor(x), torch.tensor(ab_t),
                                             torch.tensor(ab_prev), torch.tensor(eps), eta)
    want = jeq.ddim.reverse_process_canonical(jnp.asarray(x), ab_t, ab_prev, jnp.asarray(eps), eta)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_reverse_process_canonical_degenerate_tau_is_finite(eta):
    """τ_i = τ_{i−1} = 0: ᾱ_t = ᾱ_prev = 1. Unguarded, σ = η·0/0 = NaN."""
    x, eps = _inputs(1)
    one = torch.tensor(1.0)
    p = teq.ddim.reverse_process_canonical(torch.tensor(x), one, one, torch.tensor(eps), eta)
    assert torch.isfinite(p.mean).all() and torch.isfinite(p.std).all()
    torch.testing.assert_close(p.mean, torch.tensor(x), rtol=0, atol=1e-6)  # identity step


def test_reference_reverse_process_and_predict_x0():
    x, eps = _inputs(2)
    ab_t, ab_prev = np.float32(0.25), np.float32(0.5)
    got = teq.ddim.reverse_process(torch.tensor(x), torch.tensor(ab_t), torch.tensor(ab_prev),
                                   torch.tensor(eps))
    want = jeq.ddim.reverse_process(jnp.asarray(x), ab_t, ab_prev, jnp.asarray(eps))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        teq.ddim.predict_x0(torch.tensor(x), torch.tensor(ab_t), torch.tensor(eps)).numpy(),
        np.asarray(jeq.ddim.predict_x0(jnp.asarray(x), ab_t, jnp.asarray(eps))),
        rtol=1e-5, atol=1e-6)


def test_ddpm_reverse_process_matches():
    x, eps = _inputs(3)
    args = [np.float32(v) for v in (0.02, 0.98, 0.4)]
    got = teq.ddpm.reverse_process(torch.tensor(x), *map(torch.tensor, args),
                                   torch.tensor(eps), torch.tensor(args[0]))
    want = jeq.ddpm.reverse_process(jnp.asarray(x), *args, jnp.asarray(eps), args[0])
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-6)


def test_gaussian_sample_uses_injected_noise_or_generator():
    mean, std = torch.zeros(3, 2), torch.full((3, 2), 2.0)
    g = teq.Gaussian(mean, std)
    noise = torch.ones(3, 2)
    torch.testing.assert_close(g.sample(noise=noise), torch.full((3, 2), 2.0))
    a = g.sample(torch.Generator().manual_seed(5))
    b = g.sample(torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pad_norm_denorm():
    x = torch.tensor([0.5, 0.25])
    torch.testing.assert_close(pad(x, 0.0), torch.tensor([0.0, 0.5, 0.25]))
    v = torch.tensor([0.0, 0.25, 1.0])
    torch.testing.assert_close(denorm(norm(v)), v)
    torch.testing.assert_close(denorm(torch.tensor([-3.0, 3.0])), torch.tensor([0.0, 1.0]))


@pytest.mark.parametrize("name", ["q_sample", "v_target", "simple_loss", "snr",
                                  "min_snr_weight_eps", "min_snr_weight_v"])
def test_training_equations_match(name):
    """The loss-side equations on the same inputs, including ᾱ = 1 (the
    sentinel), where SNR is clamped instead of dividing by zero. f32, rtol 1e-6."""
    r = np.random.default_rng(5)
    x0, eps = r.standard_normal((2, 3, 4, 4)).astype(np.float32), \
        r.standard_normal((2, 3, 4, 4)).astype(np.float32)
    ab = np.array([1.0, 0.7, 0.3, 4e-5], np.float32).reshape(2, 2, 1, 1)[:, :1]
    fns = {
        "q_sample": lambda m, a, x, e: m.q_sample(x, a, e),
        "v_target": lambda m, a, x, e: m.v_target(x, a, e),
        "simple_loss": lambda m, a, x, e: m.simple_loss(e, x),
        "snr": lambda m, a, x, e: m.snr(a),
        "min_snr_weight_eps": lambda m, a, x, e: m.min_snr_weight(a, 5.0),
        "min_snr_weight_v": lambda m, a, x, e: m.min_snr_weight(a, 5.0, "v"),
    }
    got = fns[name](teq.ddpm, torch.tensor(ab), torch.tensor(x0), torch.tensor(eps))
    want = fns[name](jeq.ddpm, jnp.asarray(ab), jnp.asarray(x0), jnp.asarray(eps))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
