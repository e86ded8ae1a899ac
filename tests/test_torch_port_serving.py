"""The port's sampling server over real HTTP, on the CPU with a tiny UNet.

Starts ``dmme_tpu_torch.serving.make_server`` on an ephemeral port and talks
to it with urllib: healthz, npy shape/range, bucketing (n=3 → bucket 4,
sliced back to 3), determinism per seed, the ddim/dpm/unipc override, the
feature-caching samplers, and 400s on bad requests and on a family's
sampler (edm, flow) sent to another family's model. A ``Sampler`` with no
device needs CUDA.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dmme_tpu_torch.diffusion import DDPM
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.serving import Sampler, make_server
from dmme_tpu_torch.training import LitDDPM

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8),
            num_blocks=1)


@pytest.fixture(scope="module")
def lit_state():
    lit = LitDDPM(model=t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True),
                  diffusion_model=DDPM.create(timesteps=6))
    return lit, lit.init_state(0, device="cpu")


@pytest.fixture(scope="module")
def server_url(lit_state):
    lit, state = lit_state
    server = make_server(Sampler(lit, state, img_size=8, device="cpu"), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    yield f"http://{host}:{port}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(url + "/sample", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def _post_error(url, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value.code, json.loads(e.value.read())["error"]


def test_healthz(server_url):
    with urllib.request.urlopen(server_url + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info == {"status": "ok", "step": 0, "img_size": 8, "device": "cpu",
                    "samplers": ["default", "ddim", "dpm", "unipc", "edm", "cached", "deep",
                                 "deep_dpm"]}


def test_npy_roundtrip_and_bucketing(server_url):
    body, ctype = _post(server_url, {"n": 3, "seed": 1, "format": "npy"})
    assert ctype == "application/octet-stream"
    imgs = np.load(io.BytesIO(body))
    assert imgs.shape == (3, 8, 8, 3) and imgs.dtype == np.float32
    assert np.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0


def test_deterministic_per_seed(server_url):
    a, _ = _post(server_url, {"n": 2, "seed": 7, "format": "npy"})
    b, _ = _post(server_url, {"n": 2, "seed": 7, "format": "npy"})
    c, _ = _post(server_url, {"n": 2, "seed": 8, "format": "npy"})
    assert a == b
    assert a != c


def test_png(server_url):
    pytest.importorskip("PIL")
    body, ctype = _post(server_url, {"n": 4, "format": "png"})
    assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("body,needle", [
    ({"format": "gif"}, "unknown format"),
    ({"n": 0}, "n must be in"),
    ({"n": 1000}, "n must be in"),
    ({"sampler": "nope"}, "unknown sampler"),
])
def test_bad_requests_get_400(server_url, body, needle):
    code, msg = _post_error(server_url, body)
    assert code == 400 and needle in msg


@pytest.mark.parametrize("name", ["edm", "flow", "cached", "deep", "deep_dpm"])
def test_samplers_not_yet_ported_get_400(server_url, lit_state, name):
    """The names the port once answered with 400, on the DDPM server: ``edm``
    and ``flow`` still get 400, naming the family they need; the
    feature-caching samplers answer with the factory's sampler on the served
    EMA weights."""
    body = {"n": 3, "seed": 4, "format": "npy", "sampler": name, "steps": 4}
    if name in ("edm", "flow"):
        code, msg = _post_error(server_url, body)
        assert code == 400 and f"sampler={name} needs" in msg
        return
    from dmme_tpu_torch.diffusion.factory import make_module_sampler
    from dmme_tpu_torch.utils.norm import denorm

    got = np.load(io.BytesIO(_post(server_url, body)[0]))
    lit, state = lit_state
    algo = make_module_sampler(lit.diffusion_model, name, 4)
    want = algo.generate(lit.model, state.ema_params, torch.Generator().manual_seed(4),
                         (4, 8, 8, 3))
    assert got.shape == (3, 8, 8, 3)
    np.testing.assert_array_equal(got, denorm(want)[:3].numpy())


@pytest.mark.parametrize("name,steps", [("ddim", 3), ("dpm", 4), ("unipc", None)])
def test_solver_override_over_http(server_url, lit_state, name, steps):
    """The override answers with the factory's algorithm on the served EMA
    weights (6 timesteps: unipc's default of 10 steps repeats τ entries)."""
    from dmme_tpu_torch.diffusion import make_sampler
    from dmme_tpu_torch.utils.norm import denorm

    body = {"n": 3, "seed": 4, "format": "npy", "sampler": name, "steps": steps}
    a, b = (np.load(io.BytesIO(_post(server_url, body)[0])) for _ in range(2))
    assert a.shape == (3, 8, 8, 3) and np.isfinite(a).all() and np.array_equal(a, b)
    lit, state = lit_state
    algo, adapt = make_sampler(lit.diffusion_model, name, steps)
    want = algo.generate(adapt(lit.model_fn), state.ema_params,
                         torch.Generator().manual_seed(4), (4, 8, 8, 3))
    np.testing.assert_array_equal(a, denorm(want)[:3].numpy())
    default = np.load(io.BytesIO(_post(server_url, dict(body, sampler="default"))[0]))
    assert not np.array_equal(a, default)


def test_unknown_paths_404(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server_url + "/nope", timeout=30)
    assert e.value.code == 404


def test_default_device_is_cuda_and_never_falls_back(lit_state, monkeypatch):
    lit, state = lit_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(lit, state, img_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(lit, state, img_size=8, device="cuda")


def test_sampler_serialises_concurrent_requests(lit_state):
    """Several threads sampling at once each get the same result as alone."""
    lit, state = lit_state
    sampler = Sampler(lit, state, img_size=8, device="cpu")
    want = sampler.sample(2, seed=3)
    results, errors = [], []

    def work():
        try:
            results.append(sampler.sample(2, seed=3))
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(results) == 4
    for r in results:
        np.testing.assert_array_equal(r, want)
