"""ProfileTrace, ``utils.profiling`` and ``models.as_model_fn`` in the port
against the JAX package.

``ProfileTrace``'s window: the hooks of both packages are driven over the
same steps with the start and stop of the trace recorded (JAX's
``jax.profiler`` and the port's ``profiling.Trace`` patched), for stride 1
and stride > 1, a window at step 0 and a run that ends inside the window.
A real ``torch.profiler`` trace file is then written on the CPU through
``fit``. ``as_model_fn`` runs the TINY UNet on seeded weights in both
packages, within rtol 1e-4 / atol 1e-5 (tests/test_ops.py's forward
tolerance).
"""

import functools
import glob
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.callbacks import profile as jprofile
from dmme_tpu.models import as_model_fn as jax_as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.utils import profiling as jprofiling
from dmme_tpu_torch import models as tmodels
from dmme_tpu_torch.callbacks import ProfileTrace
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.training import LitDDPM, fit
from dmme_tpu_torch.utils import profiling
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8), num_blocks=1)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _drive(callback, max_steps, stride, log):
    """``fit``'s hook order for a run of ``max_steps`` steps in chunks of
    ``stride``; ``log`` records (event, the step last run)."""
    state = types.SimpleNamespace(params={"w": torch.zeros(2)})
    log["step"] = 0
    callback.on_fit_start(lit=None, state=state)
    step = 0
    while step < max_steps:
        step += min(stride, max_steps - step)
        log["step"] = step
        callback.on_train_step_end(step, lit=None, state=state, stride=stride)
    callback.on_fit_end(lit=None, state=state)
    return log["events"]


def _jax_window(monkeypatch, start, num, max_steps, stride):
    log = {"events": []}
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: log["events"].append(("start", log["step"])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: log["events"].append(("stop", log["step"])))
    monkeypatch.setattr(jprofile, "sync", lambda tree: None)
    cb = jprofile.ProfileTrace(start_step=start, num_steps=num, log_dir="unused")
    return _drive(cb, max_steps, stride, log)


def _port_window(monkeypatch, start, num, max_steps, stride):
    log = {"events": []}

    class Recorder:
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def start(self):
            log["events"].append(("start", log["step"]))

        def stop(self):
            log["events"].append(("stop", log["step"]))
            return "recorded"

    monkeypatch.setattr(profiling, "Trace", Recorder)
    cb = ProfileTrace(start_step=start, num_steps=num, log_dir="unused")
    return _drive(cb, max_steps, stride, log)


@pytest.mark.parametrize("start,num,max_steps,stride", [
    (3, 2, 10, 1),   # stride 1: open after step 2, close after step 4
    (6, 3, 20, 4),   # stride 4: the window snaps to chunk ends
    (5, 4, 20, 3),
    (0, 2, 6, 1),    # a window at step 0 opens before any step
    (0, 3, 12, 4),
    (4, 10, 7, 1),   # the run ends inside the window: on_fit_end closes it
    (9, 2, 5, 1),    # the window lies past the run: never opened
])
def test_profile_trace_window_equals_jax(monkeypatch, start, num, max_steps, stride):
    want = _jax_window(monkeypatch, start, num, max_steps, stride)
    got = _port_window(monkeypatch, start, num, max_steps, stride)
    assert got == want
    assert [e for e, _ in got] in ([], ["start", "stop"])


def test_profile_trace_writes_a_torch_profiler_trace_through_fit(tmp_path):
    """``ProfileTrace(start_step=1, num_steps=1)`` on a 3-step TINY fit: one
    ``*.pt.trace.json`` in ``log_dir`` holding the window's host operations."""
    lit = LitDDPM(warmup=10, timesteps=10, dtype="f32",
                  model=t_ddpm.UNet(dtype=torch.float32, **TINY))
    cb = ProfileTrace(start_step=1, num_steps=1, log_dir=str(tmp_path / "profile"))
    fit(lit, CIFAR10(synthetic=True, synthetic_size=8, batch_size=4), max_steps=3,
        callbacks=[cb], log_every=10, device="cpu")
    files = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    assert files == [cb.path]
    with open(cb.path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_trace_sync_and_timed(tmp_path):
    with profiling.trace(str(tmp_path)) as session:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert session.log_dir == str(tmp_path)
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
    profiling.sync({"a": [torch.ones(2), (torch.zeros(1),)]})  # nothing to wait for on the CPU
    profiling.sync({})
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    assert profiling.timed(fn, torch.ones(3), iters=4, warmup=2) >= 0.0
    assert len(calls) == 6
    assert jprofiling.timed(lambda x: x * 2, jnp.ones(3), iters=4, warmup=2) >= 0.0


@pytest.mark.parametrize("m,k,n", [(3, 4, 5), (16, 32, 8)])
def test_flops_estimate_counts_a_matmul(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    assert profiling.flops_estimate(torch.matmul, a, b) == {"flops": 2.0 * m * n * k}


def _jax_params(model, x, t, seed, **kw):
    shapes = jax.eval_shape(functools.partial(model.init, **kw), jax.random.PRNGKey(0), x, t)
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if path[-1].key == "kernel" else 0.1
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * r.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("num_classes", [None, 3])
def test_as_model_fn_matches_jax(num_classes):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 7])
    y = None if num_classes is None else np.array([0, 2])
    jmodel = jax_ddpm.UNet(**TINY, num_classes=num_classes)
    kw = {} if y is None else {"y": jnp.asarray(y)}
    params = _jax_params(jmodel, jnp.asarray(x), jnp.asarray(t), seed=2, **kw)
    want = jax.jit(jax_as_model_fn(jmodel))(params, jnp.asarray(x), jnp.asarray(t), **kw)
    module = t_ddpm.UNet(dtype=torch.float32, **TINY, num_classes=num_classes)
    fn = tmodels.as_model_fn(module)
    tkw = {} if y is None else {"y": torch.from_numpy(y)}
    got = fn(from_flax(params), torch.from_numpy(x), torch.from_numpy(t), **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    # train=False with a generator draws nothing: the same output again
    again = fn(from_flax(params), torch.from_numpy(x), torch.from_numpy(t), train=False,
               generator=torch.Generator().manual_seed(0), **tkw)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert "as_model_fn" in tmodels.__all__
