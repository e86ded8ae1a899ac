"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode, as tests/test_ops.py does. f32
tolerances are tests/test_ops.py's: rtol 2e-4 / atol 2e-5 for GroupNorm+SiLU
and attention forwards, rtol 2e-3 / atol 2e-4 for the GroupNorm+SiLU
gradients, rtol 1e-4 / atol 1e-5 for the fused ResBlock. The kernels
themselves build and run only on a CUDA device; chip_smoke.py holds them
against these plain versions there.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.ops.attention import attention as jax_attention
from dmme_tpu.ops.attention import attention_heads as jax_attention_heads
from dmme_tpu.ops.group_norm import group_norm_silu as jax_gn_silu
from dmme_tpu.ops.resblock import resblock_forward as jax_resblock
from dmme_tpu_torch.ops import attention as t_attention
from dmme_tpu_torch.ops import build
from dmme_tpu_torch.ops import group_norm as t_group_norm
from dmme_tpu_torch.ops import resblock as t_resblock

torch.set_num_threads(1)

# the modules themselves: ``dmme_tpu.ops`` exports functions of the same names
jax_attention_module = importlib.import_module("dmme_tpu.ops.attention")
jax_group_norm_module = importlib.import_module("dmme_tpu.ops.group_norm")

GN_TOL = dict(rtol=2e-4, atol=2e-5)
GN_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
RES_TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


class TestGroupNormSiLU:
    @pytest.mark.parametrize("c,groups", [(16, 4), (32, 8)])
    def test_plain_matches_interpret(self, c, groups):
        r = np.random.default_rng(0)
        x, gamma, beta = _rand(r, 2, 8, 8, c), _rand(r, c), _rand(r, c)
        want = jax_gn_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups,
                           force="interpret")
        got = t_group_norm.group_norm_silu(torch.tensor(x), torch.tensor(gamma),
                                           torch.tensor(beta), groups)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)

    def test_pre_bias(self):
        r = np.random.default_rng(1)
        x, bias = _rand(r, 2, 4, 4, 16), _rand(r, 2, 16)
        gamma, beta = 1.0 + 0.1 * _rand(r, 16), _rand(r, 16)
        want = jax_gn_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 4,
                           pre_bias=jnp.asarray(bias), force="interpret")
        got = t_group_norm.group_norm_silu(torch.tensor(x), torch.tensor(gamma),
                                           torch.tensor(beta), 4, pre_bias=torch.tensor(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)

    def test_per_sample_film_affine(self):
        r = np.random.default_rng(2)
        x, s, b = _rand(r, 3, 4, 4, 16), _rand(r, 3, 16), _rand(r, 3, 16)
        want = jax_gn_silu(jnp.asarray(x), 1.0 + jnp.asarray(s), jnp.asarray(b), 4,
                           force="interpret")
        got = t_group_norm.group_norm_silu(torch.tensor(x), 1.0 + torch.tensor(s),
                                           torch.tensor(b), 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)

    def test_stats_outputs(self):
        """The (N, G) mean and inverse std match the statistics of x + bias."""
        r = np.random.default_rng(3)
        x, bias = torch.tensor(_rand(r, 2, 4, 4, 8)), torch.tensor(_rand(r, 2, 8))
        _, mean, inv = t_group_norm.group_norm_silu_fwd(
            x, torch.ones(8), torch.zeros(8), 2, pre_bias=bias)
        u = (x + bias[:, None, None, :]).reshape(2, 16, 2, 4).double()
        torch.testing.assert_close(mean.double(), u.mean(dim=(1, 3)), rtol=1e-5, atol=1e-6)
        var = u.var(dim=(1, 3), unbiased=False)
        torch.testing.assert_close(inv.double(), (var + 1e-5).rsqrt(), rtol=1e-4, atol=1e-5)


class TestGroupNormSiLUBackward:
    @pytest.mark.parametrize("pre_bias", [False, True], ids=["no_bias", "pre_bias"])
    @pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
    def test_function_grads_match_jax(self, per_sample, pre_bias):
        """jax.grad through the interpret-mode Pallas forward and backward
        against autograd through :class:`GroupNormSiLU`: dx, dγ and dβ in
        the shape they were given ((C,) shared by the batch, or (N, C)), and
        d(pre_bias)."""
        r = np.random.default_rng(11 + 2 * per_sample + pre_bias)
        n, c = 2, 16
        aff = (n, c) if per_sample else (c,)
        x = _rand(r, n, 4, 4, c)
        gamma, beta = 1.0 + 0.1 * _rand(r, *aff), 0.1 * _rand(r, *aff)
        bias = 0.2 * _rand(r, n, c) if pre_bias else None

        def jloss(args):
            xx, gg, bb, cc = args
            return jnp.sum(jnp.sin(jax_gn_silu(xx, gg, bb, 4, pre_bias=cc, force="interpret")))

        jargs = tuple(None if a is None else jnp.asarray(a) for a in (x, gamma, beta, bias))
        want = jax.grad(jloss)(jargs)
        targs = [None if a is None else torch.tensor(a, requires_grad=True)
                 for a in (x, gamma, beta, bias)]
        y = t_group_norm.group_norm_silu(*targs[:3], 4, pre_bias=targs[3])
        assert "GroupNormSiLU" in y.grad_fn.name()
        torch.sin(y).sum().backward()
        for name, t, w in zip(("dx", "dgamma", "dbeta", "dbias"), targs, want):
            if t is None:
                continue
            assert t.grad.shape == t.shape, name
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **GN_GRAD_TOL)

    def test_plain_backward_matches_bwd_kernel(self):
        """:func:`gn_silu_bwd_plain` against ``_bwd_pallas`` in interpret
        mode on the same statistics and incoming gradient: all four outputs."""
        r = np.random.default_rng(21)
        n, c, groups = 2, 32, 8
        x, dz = _rand(r, n, 4, 4, c), _rand(r, n, 4, 4, c)
        gamma, beta = 1.0 + 0.1 * _rand(r, n, c), 0.1 * _rand(r, n, c)
        bias = 0.2 * _rand(r, n, c)
        j = [jnp.asarray(a) for a in (x, gamma, beta, bias)]
        _, mean, inv = jax_group_norm_module._fwd_pallas(*j, groups, 1e-5, n, interpret=True)
        want = jax_group_norm_module._bwd_pallas(*j, mean, inv, jnp.asarray(dz), groups, 1e-5,
                                                 n, interpret=True)
        got = t_group_norm.gn_silu_bwd_plain(
            torch.tensor(x), torch.tensor(dz), torch.tensor(gamma), torch.tensor(beta),
            torch.tensor(bias), torch.tensor(np.asarray(mean)), torch.tensor(np.asarray(inv)),
            groups)
        for name, g, w in zip(("dx", "dgamma", "dbeta", "dbias"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GN_GRAD_TOL)

    def test_bf16_pre_bias_gets_a_bf16_grad(self):
        """The ResBlock's pre-bias arrives in bf16 from its Dense layer; its
        gradient goes back in bf16, and a (C,) affine's in f32 (C,)."""
        r = np.random.default_rng(23)
        x = torch.tensor(_rand(r, 2, 4, 4, 8)).to(torch.bfloat16).requires_grad_()
        bias = torch.tensor(_rand(r, 2, 8)).to(torch.bfloat16).requires_grad_()
        gamma = torch.ones(8, requires_grad=True)
        y = t_group_norm.group_norm_silu(x, gamma, torch.zeros(8), 2, pre_bias=bias)
        y.float().sum().backward()
        assert y.dtype == x.grad.dtype == bias.grad.dtype == torch.bfloat16
        assert gamma.grad.dtype == torch.float32 and gamma.grad.shape == (8,)


class TestAttention:
    @pytest.mark.parametrize("t,d", [(16, 32), (64, 16), (64, 64)])
    def test_plain_matches_interpret(self, t, d):
        r = np.random.default_rng(t + d)
        q, k, v = (_rand(r, 3, t, d) for _ in range(3))
        scale = d ** -0.5
        want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                             force="interpret")
        got = t_attention.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)

    def test_heads_matches_jax(self):
        """(N, T, H, D) multi-head entry on strided views of a packed qkv."""
        r = np.random.default_rng(7)
        n, t, h, d = 2, 16, 4, 8
        qkv = _rand(r, n, t, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        want = jax_attention_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.1)
        tq = torch.tensor(qkv)
        got = t_attention.attention_heads(tq[:, :, 0], tq[:, :, 1], tq[:, :, 2], 0.1)
        assert got.shape == (n, t, h, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


    def test_function_backward_matches_fused_bwd(self):
        """Autograd through :class:`Attention` on strided views of a packed
        qkv against ``_fused_bwd``, the JAX package's recompute backward:
        the packed gradient holds dq, dk and dv in place."""
        r = np.random.default_rng(8)
        n, t, h, d = 2, 16, 2, 8
        qkv, g = _rand(r, n, t, 3, h, d), _rand(r, n, t, h, d)
        scale = 0.3

        def flat(a):  # (N, T, H, D) -> (N·H, T, D)
            return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(n * h, t, d)

        res = tuple(flat(qkv[:, :, i]) for i in range(3))
        want = jax_attention_module._fused_bwd(scale, res, flat(g))
        tq = torch.tensor(qkv, requires_grad=True)
        out = t_attention.attention_heads(tq[:, :, 0], tq[:, :, 1], tq[:, :, 2], scale)
        assert "Attention" in out.grad_fn.name()
        out.backward(torch.tensor(g))
        for i, name in enumerate(("dq", "dk", "dv")):
            got = tq.grad[:, :, i].transpose(1, 2).reshape(n * h, t, d)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[i]), err_msg=name,
                                       **ATTN_TOL)


def _resblock_inputs(r, n, hw, cin, cout, film, proj):
    x = _rand(r, n, hw, hw, cin)
    g1, b1v = 1.0 + 0.1 * _rand(r, n, cin), 0.1 * _rand(r, n, cin)
    if film:  # FiLM folds into a per-sample affine with no pre-bias
        pre2 = np.zeros((n, cout), np.float32)
        g2, b2v = 1.0 + 0.3 * _rand(r, n, cout), 0.3 * _rand(r, n, cout)
    else:
        pre2 = _rand(r, n, cout)
        g2 = np.broadcast_to(1.0 + 0.1 * _rand(r, cout), (n, cout)).copy()
        b2v = np.broadcast_to(0.1 * _rand(r, cout), (n, cout)).copy()
    w1 = 0.2 * _rand(r, 3, 3, cin, cout)
    b1 = 0.1 * _rand(r, cout)
    w2 = 0.2 * _rand(r, 3, 3, cout, cout)
    b2 = 0.1 * _rand(r, cout)
    wr = 0.3 * _rand(r, 1, 1, cin, cout) if proj else None
    br = 0.1 * _rand(r, cout) if proj else None
    return x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br


class TestResBlock:
    @pytest.mark.parametrize("film", [False, True], ids=["additive", "film"])
    @pytest.mark.parametrize("cin,cout", [(16, 16), (8, 16)], ids=["identity", "proj"])
    def test_plain_matches_interpret(self, film, cin, cout):
        r = np.random.default_rng(cin * 10 + film)
        args = _resblock_inputs(r, 2, 6, cin, cout, film, proj=cin != cout)
        x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br = args
        want = jax_resblock(*(jnp.asarray(a) for a in args[:10]),
                            wr=None if wr is None else jnp.asarray(wr),
                            br=None if br is None else jnp.asarray(br),
                            num_groups=4, force="interpret")

        def oihw(w):
            return None if w is None else torch.tensor(w.transpose(3, 2, 0, 1).copy())

        t = torch.tensor
        got = t_resblock.resblock_forward(
            t(x), t(g1), t(b1v), t(pre2), t(g2), t(b2v), oihw(w1), t(b1), oihw(w2), t(b2),
            wr=oihw(wr), br=None if br is None else t(br), num_groups=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RES_TOL)

    def test_pack_weights_layout_and_cache(self):
        """K-major bf16 weights, one row per output channel with K ordered
        (dy, dx, c_in), the projection's rows appended to conv2's and its
        bias folded into b2: unpacked on the CPU they equal the OIHW weights
        bit for bit. One pack per weight state: the same tensors give the
        same pack until one of them changes in place."""
        r = np.random.default_rng(9)
        cin, cout = 8, 16
        w1, w2 = torch.tensor(_rand(r, cout, cin, 3, 3)), torch.tensor(_rand(r, cout, cout, 3, 3))
        wr = torch.tensor(_rand(r, cout, cin, 1, 1))
        b1, b2, br = (torch.tensor(_rand(r, cout)) for _ in range(3))
        pw = t_resblock.pack_weights(w1, b1, w2, b2, wr, br)
        assert pw.w1.dtype == pw.w2.dtype == pw.wr.dtype == torch.bfloat16
        assert pw.w1.shape == (cout, 9 * cin) and pw.w2.shape == (cout, 9 * cout + cin)
        assert pw.w1.is_contiguous() and pw.w2.is_contiguous()

        def unpack(p, c):  # (C_out, 9·C) -> OIHW
            return p.reshape(cout, 3, 3, c).permute(0, 3, 1, 2)

        assert torch.equal(unpack(pw.w1, cin), w1.to(torch.bfloat16))
        assert torch.equal(unpack(pw.w2[:, :9 * cout], cout), w2.to(torch.bfloat16))
        assert torch.equal(pw.wr, wr[:, :, 0, 0].to(torch.bfloat16))
        assert pw.wr.data_ptr() == pw.w2[:, 9 * cout:].data_ptr()
        torch.testing.assert_close(pw.b2, b2 + br, rtol=0, atol=0)
        assert t_resblock.pack_weights(w1, b1, w2, b2, wr, br) is pw
        with torch.no_grad():
            w1.mul_(-1.0)
        again = t_resblock.pack_weights(w1, b1, w2, b2, wr, br)
        assert again is not pw
        torch.testing.assert_close(again.w1, -pw.w1, rtol=0, atol=0)
        identity = t_resblock.pack_weights(w2, b1, w2, b2)
        assert identity.wr is None and identity.w2.shape == (cout, 9 * cout)
        assert torch.equal(unpack(identity.w2, cout), w2.to(torch.bfloat16))
        torch.testing.assert_close(identity.b2, b2, rtol=0, atol=0)

    def test_broadcast_affine_rows_are_not_copied(self):
        g = torch.arange(8, dtype=torch.float32)
        for v in (g, g[None].expand(3, -1)):
            row, stride = t_group_norm.broadcast_rows(v, 3, 8)
            assert stride == 0 and row.data_ptr() == g.data_ptr()
        per_sample = torch.arange(24, dtype=torch.float32).reshape(3, 8)
        row, stride = t_group_norm.broadcast_rows(per_sample, 3, 8)
        assert stride == 8 and row.data_ptr() == per_sample.data_ptr()
        row, stride = t_group_norm.broadcast_rows(per_sample.t().contiguous().t(), 3, 8)
        assert stride == 8 and row.is_contiguous()
        torch.testing.assert_close(row, per_sample, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["group_norm_silu", "group_norm_silu_bwd", "resblock"])
def test_launchers_take_bf16_only(kernel):
    """The launchers refuse another dtype before they reach a kernel."""
    x = torch.zeros((1, 4, 4, 64))
    v = torch.ones(64)
    with pytest.raises(TypeError, match="bf16"):
        if kernel == "group_norm_silu":
            t_group_norm._launch(x, v, v, None, 32, 1e-5)
        elif kernel == "group_norm_silu_bwd":
            stats = torch.zeros((1, 32))
            t_group_norm._launch_bwd(x, x, v, v, None, stats, stats, 32)
        else:
            w = torch.zeros((64, 64, 3, 3))
            t_resblock._launch(x, v, v, v, v, v, w, v, w, v, None, None, 32, 1e-5)


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """On the CPU every wrapper takes its plain version: no ctypes library is
    built or bound, and no launch is counted."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(t_group_norm, "_fwd_fn", refuse)
    monkeypatch.setattr(t_group_norm, "_bwd_fn", refuse)
    before = (t_group_norm.launches, t_group_norm.bwd_launches, t_attention.launches,
              t_resblock.launches)
    r = np.random.default_rng(0)
    x = torch.tensor(_rand(r, 1, 4, 4, 8), requires_grad=True)
    t_group_norm.group_norm_silu(x, torch.ones(8), torch.zeros(8), 2).sum().backward()
    q = torch.tensor(_rand(r, 1, 16, 16), requires_grad=True)
    t_attention.attention(q, q, q, 0.25).sum().backward()
    t_attention.attention_heads(q[:, :, None], q[:, :, None], q[:, :, None], 0.25)
    args = _resblock_inputs(r, 1, 4, 8, 8, False, False)
    t = torch.tensor
    t_resblock.resblock_forward(*(t(a) for a in args[:6]),
                                t(args[6].transpose(3, 2, 0, 1).copy()), t(args[7]),
                                t(args[8].transpose(3, 2, 0, 1).copy()), t(args[9]),
                                num_groups=2)
    assert (t_group_norm.launches, t_group_norm.bwd_launches, t_attention.launches,
            t_resblock.launches) == before


@pytest.mark.parametrize("requires_grad", ["x", "w1", "pre2"])
def test_resblock_refuses_to_run_under_grad(requires_grad):
    """The fused ResBlock has no backward: with grad mode on and any input
    requiring grad it raises, instead of returning a result detached from
    that input; under no_grad the same call runs."""
    r = np.random.default_rng(3)
    x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, _, _ = _resblock_inputs(r, 1, 4, 8, 8, False,
                                                                         False)
    args = dict(x=torch.tensor(x), g1=torch.tensor(g1), b1v=torch.tensor(b1v),
                pre2=torch.tensor(pre2), g2=torch.tensor(g2), b2v=torch.tensor(b2v),
                w1=torch.tensor(w1.transpose(3, 2, 0, 1).copy()), b1=torch.tensor(b1),
                w2=torch.tensor(w2.transpose(3, 2, 0, 1).copy()), b2=torch.tensor(b2))
    args[requires_grad].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        t_resblock.resblock_forward(**args, num_groups=2)
    with torch.no_grad():
        out = t_resblock.resblock_forward(**args, num_groups=2)
    assert out.shape == (1, 4, 4, 8) and torch.isfinite(out).all()


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_group_norm.group_norm_silu(x, torch.ones(8), torch.zeros(8), 2)
    q = torch.empty((1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_attention.attention(q, q, q, 0.25)
    w = torch.empty((8, 8, 3, 3), device="meta")
    v = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_resblock.resblock_forward(x, v, v, v, v, v, w, v[0], w, v[0], num_groups=2)
    stats = torch.empty((1, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_group_norm.group_norm_silu_bwd(x, x, v[0], v[0], None, stats, stats, 2)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A CUDA source that does not compile raises with the compiler's output,
    and nothing is loaded. The Python interpreter stands in for a compiler
    that rejects every argument."""
    monkeypatch.setattr(build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="usage") as e:
        build.build_all()
    assert "nvcc attention.cu failed" in str(e.value)
    assert "nvcc resblock.cu failed" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so")) and build._LIBS == {}


def test_library_name_follows_the_source_hash():
    name = build._target("resblock").name
    assert name.startswith("libresblock-") and name.endswith(".so")
    assert build._target("attention").name != name
    headers = {p.name for p in build.local_includes(build.CSRC / "resblock.cu")}
    assert "hopper.cuh" in headers


def test_library_name_follows_the_local_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes, directly or through another
    header under csrc/, renames the library, so it is rebuilt."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    assert [p.name for p in build.local_includes(tmp_path / "k.cu")] == ["a.cuh", "b.cuh"]
    names = [build._target("k").name]
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    names.append(build._target("k").name)
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A (B + 1)\n')
    names.append(build._target("k").name)
    assert len(set(names)) == 3 and all(n.startswith("libk-") for n in names)
    (tmp_path / "unrelated.cuh").write_text("#define C 3\n")
    assert build._target("k").name == names[-1]


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi2EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi2EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    assert build.ptxas_usage(log) == {
        "_Z6kernelILi2EEvv": {"registers": 90, "spill_stores": 0, "spill_loads": 0},
        "_Z5otherv": {"registers": 255, "spill_stores": 16, "spill_loads": 8}}


def test_sm_count_is_asked_once_per_device(monkeypatch):
    asked = []

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: asked.append(i) or Props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 5)
    build._sm_count.cache_clear()
    try:
        assert [build.sm_count("cuda:3") for _ in range(3)] == [132] * 3
        assert build.sm_count("cuda") == build.sm_count(torch.device("cuda", 5)) == 132
        assert asked == [3, 5]
    finally:
        build._sm_count.cache_clear()


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "kernel"), (torch.float32, "simt"),
                                        (torch.float16, "simt")])
def test_route_sends_bf16_to_the_kernel_and_other_dtypes_to_the_plain_path(dtype, want):
    """bf16 CUDA tensors go to the tensor-core kernels, f32 and fp16 ones to
    those of ``simt.cu``; only a CPU tensor takes the plain version."""
    from dmme_tpu_torch.ops import route

    assert route(torch.device("cuda"), dtype, "x") == want
    assert route(torch.device("cuda", 1), dtype, "x") == want
    assert route(torch.device("cpu"), dtype, "x") == "cpu"
    with pytest.raises(ValueError, match="no kernel"):
        route(torch.device("meta"), dtype, "x")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_route_raises_on_the_card_for_a_dtype_without_a_kernel(dtype):
    from dmme_tpu_torch.ops import route

    assert route(torch.device("cpu"), dtype, "x") == "cpu"
    with pytest.raises(TypeError, match="no kernel for"):
        route(torch.device("cuda"), dtype, "x")


@pytest.mark.parametrize("kernel", ["group_norm_silu", "group_norm_silu_bwd", "attention",
                                    "resblock"])
def test_simt_launchers_take_f32_and_fp16_only(kernel):
    """The ``simt.cu`` launchers refuse bf16 before they reach a kernel."""
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    v = torch.ones(64)
    with pytest.raises(TypeError, match="f32 or fp16"):
        if kernel == "group_norm_silu":
            t_group_norm._launch_simt(x, v, v, None, 32, 1e-5)
        elif kernel == "group_norm_silu_bwd":
            stats = torch.zeros((1, 32))
            t_group_norm._launch_bwd_simt(x, x, v, v, None, stats, stats, 32)
        elif kernel == "attention":
            t_attention._launch_simt(x, x, x, 0.125)
        else:
            w = torch.zeros((64, 64, 3, 3))
            t_resblock._launch_simt(x, v, v, v, v, v, w, v, w, v, None, None, 32, 1e-5)


def test_pack_weights_caches_per_dtype():
    """K4's packed weights are kept per dtype: the bf16 kernels and the
    f32/fp16 ones each read the conv weights in their activations' dtype."""
    r = np.random.default_rng(3)
    w1, w2 = (torch.tensor(r.standard_normal((16, 16, 3, 3)), dtype=torch.float32)
              for _ in range(2))
    b1, b2 = torch.zeros(16), torch.ones(16)
    packed = {dt: t_resblock.pack_weights(w1, b1, w2, b2, dtype=dt)
              for dt in (torch.bfloat16, torch.float32, torch.float16)}
    for dt, pw in packed.items():
        assert pw.w1.dtype == pw.w2.dtype == dt and pw.b1.dtype == torch.float32
        assert t_resblock.pack_weights(w1, b1, w2, b2, dtype=dt) is pw
        np.testing.assert_array_equal(
            pw.w1.float().numpy(),
            w1.permute(0, 2, 3, 1).reshape(16, 144).to(dt).float().numpy())
    assert t_resblock.pack_weights(w1, b1, w2, b2) is packed[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_wrappers_dispatch_on_the_card_by_dtype(monkeypatch, dtype):
    """Each wrapper with its tensors taken for CUDA ones (``route`` asked as
    for a CUDA device): bf16 reaches the tensor-core launcher, f32 and fp16
    the ``simt.cu`` launcher; neither gives way to the plain version."""
    from dmme_tpu_torch import ops

    def as_cuda(device, dt, what):
        return ops.route(torch.device("cuda"), dt, what)

    launched = []

    def launcher(name):
        def fn(*a, **k):
            launched.append(name)
            raise RuntimeError("launched")
        return fn

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    simt = dtype != torch.bfloat16
    for mod in (t_group_norm, t_attention, t_resblock):
        name = mod.__name__.split(".")[-1]
        monkeypatch.setattr(mod, "route", as_cuda)
        monkeypatch.setattr(mod, "_launch", launcher(name))
        monkeypatch.setattr(mod, "_launch_simt", launcher(name + "_simt"))
    monkeypatch.setattr(t_group_norm, "_launch_bwd", launcher("group_norm_bwd"))
    monkeypatch.setattr(t_group_norm, "_launch_bwd_simt", launcher("group_norm_bwd_simt"))
    for mod, fn in ((t_group_norm, "gn_silu_plain"), (t_group_norm, "gn_silu_bwd_plain"),
                    (t_attention, "attention_heads_plain"), (t_resblock, "resblock_plain")):
        monkeypatch.setattr(mod, fn, refuse)
    r = np.random.default_rng(0)
    x = torch.tensor(_rand(r, 1, 4, 4, 8)).to(dtype)
    q = torch.tensor(_rand(r, 1, 16, 1, 16)).to(dtype)
    args = _resblock_inputs(r, 1, 4, 8, 8, False, False)
    t = torch.tensor
    res = (t(args[0]).to(dtype), *(t(a) for a in args[1:6]),
           t(args[6].transpose(3, 2, 0, 1).copy()), t(args[7]),
           t(args[8].transpose(3, 2, 0, 1).copy()), t(args[9]))
    stats = torch.zeros((1, 2))
    calls = {
        "group_norm": lambda: t_group_norm.group_norm_silu_fwd(x, torch.ones(8), torch.zeros(8),
                                                               2),
        "group_norm_bwd": lambda: t_group_norm.group_norm_silu_bwd(
            x, x, torch.ones(8), torch.zeros(8), None, stats, stats + 1.0, 2),
        "attention": lambda: t_attention.attention_heads(q, q, q, 0.25),
        "resblock": lambda: t_resblock.resblock_forward(*res, num_groups=2),
    }
    for call in calls.values():
        with pytest.raises(RuntimeError, match="launched"):
            call()
    assert launched == [name + ("_simt" if simt else "") for name in calls]
