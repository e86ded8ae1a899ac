"""The premise of the f32 kernels of K3 and K4, checked on the CPU: 3xTF32.

On the card an f32 operand x is split into hi = tf32(x) and lo = tf32(x −
hi) (``dmme_tpu_torch.ops.tf32_split``, bit for bit ``cvt.rna.tf32.f32``),
and each product is hi·hi + hi·lo + lo·hi with f32 accumulation. Here the
same split and the same three products (f32 matmuls on the CPU, whose
products of tf32 values are exact) are held against f64 at TINY conv and
attention shapes: within 1e-6 relative L2, where the one-product sum (plain
TF32) misses the 1e-4 that the f32 harness is held to on the card. The
attention case also runs the JAX package's Pallas kernel (interpret mode) in
f32 against the same f64 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.ops.attention import _attention_pallas
from dmme_tpu_torch.ops import tf32_round, tf32_split

torch.set_num_threads(1)

THREE = 1e-6  # relative L2 of the 3xTF32 sums against f64
ONE = 1e-4  # the f32 harness's limit on the card, which one tf32 product misses


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """tf32 of normal f32 values by the rule itself: 11 significant bits,
    to nearest, ties away from zero, in f64."""
    m, e = np.frexp(x.astype(np.float64))  # |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0 ** 11
    return (np.sign(m) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    r = np.random.default_rng(0)
    x = (r.standard_normal(20000) * np.exp(r.uniform(-20, 20, 20000))).astype(np.float32)
    # exact ties: the 13 dropped bits 0x1000, both signs
    ties = (np.arange(1, 9, dtype=np.int32) << 13 | 0x1000 | (127 << 23)).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, 1.0, -2.5, 65504.0])])
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()  # low 13 bits clear
    assert (np.abs(got[len(x) - 20:len(x) - 12]) > np.abs(ties)).all()  # ties away from zero


def test_tf32_split_reconstructs_to_2_pow_minus_22():
    r = np.random.default_rng(1)
    x = torch.from_numpy((r.standard_normal(50000) * 10.0).astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())


def _products(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b in f32 from tf32 halves: hi·hi + hi·lo + lo·hi (the small
    products first, as the kernels issue them), or hi·hi alone."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if not three:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """NHWC x → (N·H·W, 9·C) rows of K4's implicit GEMM, K ordered (dy, dx,
    c), zeros outside the image."""
    n, h, w, c = x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [pad[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(n * h * w, 9 * c)


@pytest.mark.parametrize("n,hw,cin,cout", [(2, 8, 16, 16), (1, 4, 32, 24), (2, 6, 8, 40)])
def test_three_products_hold_a_conv_to_f64(n, hw, cin, cout):
    """K4's conv as its implicit GEMM (the packed weights' K order) with a
    1×1 projection appended to K: 3xTF32 within 1e-6 of f64, one tf32
    product not within 1e-4."""
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((n, hw, hw, cin)).astype(np.float32))
    h = torch.nn.functional.silu(x)  # an activation as GN+SiLU hands it over
    w = torch.from_numpy(r.standard_normal((cout, 9 * cin + cin)).astype(np.float32)) * 0.1
    a = torch.cat([_im2col(h), x.reshape(-1, cin)], dim=1)  # the projection's x continues K
    want = a.double() @ w.double().t()
    three = _rel_l2(_products(a, w.t(), True), want)
    one = _rel_l2(_products(a, w.t(), False), want)
    assert three <= THREE, three
    assert one > ONE, one
    # the same sums on the NCHW convolution: the K order is the conv's
    conv = torch.nn.functional.conv2d(
        h.double().permute(0, 3, 1, 2),
        w[:, :9 * cin].double().reshape(cout, 3, 3, cin).permute(0, 3, 1, 2), padding=1)
    proj = x.double().reshape(-1, cin) @ w[:, 9 * cin:].double().t()
    torch.testing.assert_close(conv.permute(0, 2, 3, 1).reshape(-1, cout) + proj, want,
                               rtol=1e-12, atol=1e-12)


def _attention_3xtf32(q, k, v, scale, three: bool):
    """K3's f32 arithmetic on (BH, T, D): S = QKᵀ from tf32 halves, the
    softmax in f32, P (f32, V's dtype) split again for PV."""
    s = _products(q, k.transpose(-1, -2), three) * scale
    p = torch.softmax(s, dim=-1)
    return _products(p, v, three)


@pytest.mark.parametrize("bh,t,d", [(2, 16, 32), (1, 64, 64), (3, 24, 48)])
def test_three_products_hold_attention_to_f64(bh, t, d):
    """K3 in f32: 3xTF32 within 1e-6 of f64 (the JAX package's kernel in
    f32 sits within the same distance), one tf32 product not within 1e-4."""
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((bh, t, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    qd, kd, vd = (torch.from_numpy(a).double() for a in (q, k, v))
    want = torch.softmax(qd @ kd.transpose(-1, -2) * scale, dim=-1) @ vd
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    three = _rel_l2(_attention_3xtf32(qt, kt, vt, scale, True), want)
    one = _rel_l2(_attention_3xtf32(qt, kt, vt, scale, False), want)
    assert three <= THREE, three
    assert one > ONE, one
    with jax.default_device(jax.devices("cpu")[0]):
        ref = _attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                interpret=True)
    assert _rel_l2(torch.from_numpy(np.array(ref)), want) <= THREE
