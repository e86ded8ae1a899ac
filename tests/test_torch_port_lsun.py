"""LSUN and ImageNet-64 in the port against the JAX package, on the same
synthetic files.

Everything that reaches the bytes of a batch is held bitwise: the category
tables, ``_decode_image``, ``resize_center_crop``, ``LSUNClass`` (decode,
validated key cache, blacklist), the ``LSUN`` concat's routing, the
``LSUN`` data module's uint8 batches in memmap and streaming modes (process
slices, ``skip_batches``, corrupt values resampled from their own stream,
the threshold's auto mode) and ``ImageFolder64`` (synthetic, ``.npz`` and
``.npy``, with and without labels). Each package reads its own copy of an
LMDB, since the key cache is written beside the data. Messages are JAX's,
word for word. The download logic runs only under a mocked ``subprocess``.

The slice as a whole: TINY-width copies of configs/ddpm/lsun_church.yaml
and configs/iddpm/imagenet64.yaml (the same class paths; f32 on the CPU,
T = 20) fit through ``trainer.main(..., device="cpu")``, and their first
batch's ``loss_given`` on injected t and ε matches JAX's at
tests/test_ops.py's forward tolerance (rtol 1e-4, atol 1e-5), the gradient
at its gradient tolerance (rtol 2e-3, atol 2e-4).
"""

import io
import os
import pickle
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmme_tpu import config as jcfg
from dmme_tpu.data import ImageFolder64 as JaxImageFolder64
from dmme_tpu.data import lsun as jlsun
from dmme_tpu.datasets import lsun as jds
from dmme_tpu_torch import config as tcfg
from dmme_tpu_torch.data import ImageFolder64
from dmme_tpu_torch.data import lsun as tlsun
from dmme_tpu_torch.datasets import lsun as tds
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import CheckpointManager
from dmme_tpu_torch.utils.convert import from_flax
from tests.lmdb_fixture import write_lmdb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _image(seed, h, w, fmt="JPEG", mode="RGB"):
    """Encoded bytes of a seeded noise image of h×w pixels."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _kv(n, sizes=((48, 64), (64, 50), (40, 40)), corrupt=()):
    kv = {f"img{i:03d}".encode(): _image(i, *sizes[i % len(sizes)]) for i in range(n)}
    for k in corrupt:
        kv[k] = b"not a jpeg"
    return kv


def _twin_dirs(tmp_path, kv, name="bedroom_train_lmdb"):
    """The same LMDB written under ``port/`` and ``jax/``."""
    dirs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        write_lmdb(str(d / name), kv)
        dirs[side] = d
    return dirs


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test compares what each package raises
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------------ datasets

def test_category_tables_match_jax():
    assert tds.SCENES == jds.SCENES and tds.OBJECTS == jds.OBJECTS
    assert tds.CORRUPT_KEYS == jds.CORRUPT_KEYS


@pytest.mark.parametrize("fmt,mode", [("JPEG", "RGB"), ("PNG", "RGBA"), ("PNG", "L"),
                                      ("BAD", None)])
def test_decode_image_matches_jax(fmt, mode):
    buf = b"not an image" if fmt == "BAD" else _image(3, 30, 41, fmt, mode)
    got, want = tds._decode_image(memoryview(buf)), jds._decode_image(memoryview(buf))
    if fmt == "BAD":
        assert got is None and want is None
    else:
        assert got.dtype == np.uint8 and got.shape == (30, 41, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,size", [(30, 40, 24), (300, 280, 64), (64, 48, 64),
                                      (50, 70, 32), (33, 33, 16)])
def test_resize_center_crop_matches_jax(h, w, size):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    got = tlsun.resize_center_crop(img, size)
    assert got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jlsun.resize_center_crop(img, size))


def _caches(d):
    return sorted(p for p in os.listdir(d) if p.startswith("_cache_"))


def test_lsun_class_decode_cache_and_blacklist(tmp_path, monkeypatch):
    kv = _kv(4, corrupt=(b"zz_corrupt",))
    kv[b"bad"] = _image(99, 20, 20)
    dirs = _twin_dirs(tmp_path, kv, "cat_lmdb")
    got = tds.LSUNClass(str(dirs["port"] / "cat_lmdb"), blacklist=[b"bad"])
    want = jds.LSUNClass(str(dirs["jax"] / "cat_lmdb"), blacklist=[b"bad"])
    assert got.keys == want.keys == sorted(k for k in kv if k.startswith(b"img"))
    assert got.reader.backend == "native"
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i], want[i])
    # the validated key cache: one pickle beside the data, JAX's contents
    assert len(_caches(dirs["port"])) == len(_caches(dirs["jax"])) == 1
    with open(dirs["port"] / _caches(dirs["port"])[0], "rb") as f:
        assert pickle.load(f) == want.keys
    # a second validated open reads the cache and decodes nothing
    monkeypatch.setattr(tds, "_decode_image", lambda buf: pytest.fail("decoded"))
    assert tds.LSUNClass(str(dirs["port"] / "cat_lmdb"), blacklist=[b"bad"]).keys == want.keys


def test_an_unvalidated_open_neither_reads_nor_writes_the_cache(tmp_path):
    kv = _kv(3, corrupt=(b"zz_corrupt",))
    dirs = _twin_dirs(tmp_path, kv)
    root = "bedroom_train_lmdb"
    got = tds.LSUNClass(str(dirs["port"] / root), validate=False)
    want = jds.LSUNClass(str(dirs["jax"] / root), validate=False)
    assert got.keys == want.keys == sorted(kv)  # the corrupt key stays
    assert _caches(dirs["port"]) == _caches(dirs["jax"]) == []
    i = got.keys.index(b"zz_corrupt")
    assert _error(lambda: got[i]) == _error(lambda: want[i]) == (
        "OSError", "undecodable value for key b'zz_corrupt'")
    # a validated open afterwards still validates, and writes the cache
    assert tds.LSUNClass(str(dirs["port"] / root)).keys == sorted(kv)[:-1]
    assert len(_caches(dirs["port"])) == 1


def test_lsun_concat_routing_and_split_resolution(tmp_path):
    for side in ("port", "jax"):
        for j, name in enumerate(("bedroom_train", "tower_train")):
            write_lmdb(str(tmp_path / side / f"{name}_lmdb"),
                       {f"{name}{i}".encode(): _image(10 * j + i, 36, 30) for i in range(3)})
    classes = ["bedroom_train", "tower_train"]
    got = tds.LSUN(str(tmp_path / "port"), classes=classes)
    want = jds.LSUN(str(tmp_path / "jax"), classes=classes)
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got.indices, want.indices)
    for i in range(6):
        np.testing.assert_array_equal(got[i], want[i])
    for split in ("train", "val", "test", ["bedroom_val", "kitchen_val"]):
        assert tds.LSUN._resolve(split) == jds.LSUN._resolve(split)
    assert _error(lambda: tds.LSUN._resolve("dev")) == _error(lambda: jds.LSUN._resolve("dev"))


# --------------------------------------------------------------- data module

def _modules(dirs, **kw):
    return (tlsun.LSUN(data_dir=str(dirs["port"]), category="bedroom", **kw),
            jlsun.LSUN(data_dir=str(dirs["jax"]), category="bedroom", **kw))


def _take(it, n):
    out = [next(it) for _ in range(n)]
    it.close()  # ends the decode pool of a streaming iterator
    return out


@pytest.mark.parametrize("streaming", [False, True])
def test_lsun_module_batches_are_jax_bytes(tmp_path, streaming):
    """Three epochs' worth of batches at seed 3, each process's slice of a
    global batch, ``skip_batches`` and ``test_iter``; with ``streaming``,
    corrupt values in the LMDB are resampled from their own stream."""
    corrupt = (b"zz_bad1", b"zz_bad2") if streaming else ()
    dirs = _twin_dirs(tmp_path, _kv(10, corrupt=corrupt))
    kw = dict(batch_size=4, imgsize=32, streaming=streaming, num_workers=2)
    got, want = _modules(dirs, **kw)
    for dm in (got, want):
        dm.prepare_data()
        dm.setup("fit")
    if streaming:
        assert got.train_data is None and got._stream_n == want._stream_n == 12
    else:
        np.testing.assert_array_equal(got.train_data, want.train_data)
        assert got.train_data.shape == (10, 32, 32, 3)
        assert os.path.exists(dirs["port"] / "bedroom_train_decoded_32.npy")
    full = _take(got.train_iter(3), 9)
    for a, b in zip(full, _take(want.train_iter(3), 9)):
        assert a.dtype == np.uint8 and a.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
    halves = [_take(got.train_iter(3, process_index=p, process_count=2), 2) for p in (0, 1)]
    for p in (0, 1):
        for a, b in zip(halves[p], _take(want.train_iter(3, process_index=p, process_count=2), 2)):
            np.testing.assert_array_equal(a, b)
    if not streaming:  # a process resamples a corrupt value of its slice on its own
        for j in range(2):
            np.testing.assert_array_equal(np.concatenate([halves[0][j], halves[1][j]]), full[j])
    np.testing.assert_array_equal(_take(got.train_iter(3, skip_batches=2), 1)[0], full[2])
    got.setup_test()
    want.setup_test()
    for a, b in zip(_take(got.test_iter(), 2), _take(want.test_iter(), 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", [4, 40])
def test_auto_mode_by_entry_count(tmp_path, threshold):
    dirs = _twin_dirs(tmp_path, _kv(6))
    got, want = _modules(dirs, imgsize=16, streaming=None, streaming_threshold=threshold)
    got.setup("fit")
    want.setup("fit")
    assert (got._stream_ds is not None) == (want._stream_ds is not None) == (threshold < 6)


def test_augment_flips_on_the_device_and_lmdb_path_follows_jax(tmp_path):
    for category, split in (("bedroom", "train"), ("bedroom", "test"), ("cat", "train"),
                            ("church_outdoor", "val")):
        kw = dict(data_dir=str(tmp_path), category=category, split=split)
        assert tlsun.LSUN(**kw).lmdb_path == jlsun.LSUN(**kw).lmdb_path
    batch = torch.arange(2 * 2 * 3 * 3, dtype=torch.uint8).reshape(2, 2, 3, 3)
    dm = tlsun.LSUN(data_dir=str(tmp_path))
    flipped = dm.augment(torch.Generator().manual_seed(0), batch)
    assert all(torch.equal(f, b) or torch.equal(f, b.flip(1)) for f, b in zip(flipped, batch))
    assert tlsun.LSUN(data_dir=str(tmp_path), horizontal_flip=False).augment(None, batch) is batch


def test_unknown_category_and_missing_lmdb_raise_jax_messages(tmp_path):
    assert _error(lambda: tlsun.LSUN(category="not_a_category")) == _error(
        lambda: jlsun.LSUN(category="not_a_category"))
    kw = dict(data_dir=str(tmp_path), category="bedroom")
    got = _error(tlsun.LSUN(**kw).prepare_data)
    assert got[0] == "FileNotFoundError" and got == _error(jlsun.LSUN(**kw).prepare_data)


def _download(module, data_dir, category, behaviour, src, monkeypatch):
    """``prepare_data`` with ``download=True`` under a fake ``aria2c``:
    (argv of each call, what it raised, the files left under data_dir)."""
    calls = []

    def fake_call(cmd):
        calls.append(list(cmd))
        out_path = cmd[cmd.index("-o") + 1]
        if behaviour == "missing":
            raise FileNotFoundError("aria2c")
        if behaviour in ("ok", "no_suffix"):
            inner = os.path.basename(dm.lmdb_path)
            if behaviour == "no_suffix":  # an archive that extracts without "_lmdb"
                inner = inner[:-len("_lmdb")]
            with zipfile.ZipFile(out_path, "w") as z:
                z.write(src, f"{inner}/data.mdb")
        elif behaviour == "corrupt_zip":
            with open(out_path, "wb") as f:
                f.write(b"PK not a zip")
        elif behaviour == "fail":
            with open(out_path, "wb") as f:
                f.write(b"partial")
            return 7
        return 0

    monkeypatch.setattr(module.subprocess, "call", fake_call)
    dm = module.LSUN(data_dir=data_dir, category=category, batch_size=1, imgsize=16,
                     download=True)
    raised = _error(dm.prepare_data)
    second = _error(dm.prepare_data) if raised is None else None  # skip-if-exists
    files = sorted(os.path.relpath(os.path.join(d, f), data_dir)
                   for d, _, fs in os.walk(data_dir) for f in fs) if os.path.isdir(data_dir) else []
    return calls, raised, second, files


@pytest.mark.parametrize("behaviour,category", [("ok", "bedroom"), ("ok", "cat"),
                                                ("no_suffix", "cat"), ("fail", "bedroom"),
                                                ("corrupt_zip", "bedroom"), ("missing", "cat")])
def test_download_logic_under_a_mocked_subprocess(tmp_path, monkeypatch, behaviour, category):
    """The aria2c argv and URL, extraction and skip-if-exists, the removal of
    a partial archive after a failed aria2c, the corrupt-zip branch, the
    rename of an archive without the ``_lmdb`` suffix, and a missing
    aria2c: the same calls, messages and files as JAX's. Nothing is fetched."""
    src = tmp_path / "src" / "data.mdb"
    write_lmdb(str(src), {b"k0": _image(0, 20, 20)})
    data_dir = str(tmp_path / "data")
    results = []
    for module in (tlsun, jlsun):
        shutil.rmtree(data_dir, ignore_errors=True)
        results.append(_download(module, data_dir, category, behaviour, src, monkeypatch))
    assert results[0] == results[1]
    calls, raised, second, files = results[0]
    assert calls[0][:5] == ["aria2c", "-x", "16", "-s", "16"]
    scenes = category == "bedroom"
    assert calls[0][5] == ("http://dl.yf.io/lsun/scenes/bedroom_train_lmdb.zip" if scenes
                           else "http://dl.yf.io/lsun/objects/cat.zip")
    if behaviour in ("ok", "no_suffix"):
        assert raised is None and second is None and len(calls) == 1
        name = "bedroom_train_lmdb" if scenes else "cat_lmdb"
        assert files == sorted([f"{name}/data.mdb", calls[0][-1][len(data_dir) + 1:]])
        dm = tlsun.LSUN(data_dir=data_dir, category=category, batch_size=1, imgsize=16)
        dm.setup("fit")
        assert _take(dm.train_iter(0), 1)[0].shape == (1, 16, 16, 3)
    else:
        assert raised[0] == "RuntimeError" and files == []


# ---------------------------------------------------------------- ImageNet-64

def _planar(images):
    return images.transpose(0, 3, 1, 2).reshape(len(images), -1)


@pytest.mark.parametrize("source", ["synthetic", "npz", "npy"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_imagefolder64_matches_jax(tmp_path, source, with_labels):
    rng = np.random.default_rng(4)
    kw = dict(data_dir=str(tmp_path), batch_size=4, with_labels=with_labels)
    if source == "synthetic":
        kw.update(synthetic=True, synthetic_size=12)
    else:
        for i, n in ((1, 6), (2, 5)):
            rows = _planar(rng.integers(0, 256, (n, 64, 64, 3), np.uint8))
            if source == "npz":
                np.savez(tmp_path / f"train_data_batch_{i}.npz", data=rows,
                         labels=rng.integers(1, 1001, n))
            else:
                np.save(tmp_path / f"train_data_batch_{i}.npy", rows)
    got, want = ImageFolder64(**kw), JaxImageFolder64(**kw)
    got.setup("fit")
    want.setup("fit")
    np.testing.assert_array_equal(got.train_data, want.train_data)
    assert got.train_data.shape == (12 if source == "synthetic" else 11, 64, 64, 3)
    if with_labels:
        np.testing.assert_array_equal(got.train_labels, want.train_labels)
        assert got.train_labels.min() >= 0 and got.train_labels.max() < 1000
    else:
        assert got.train_labels is None and want.train_labels is None
    for a, b in zip(_take(got.train_iter(1), 3), _take(want.train_iter(1), 3)):
        for x, y in zip(a if with_labels else (a,), b if with_labels else (b,)):
            np.testing.assert_array_equal(x, y)


def test_imagefolder64_missing_data_raises_jax_message(tmp_path):
    got = _error(lambda: ImageFolder64(data_dir=str(tmp_path)).setup("fit"))
    assert got[0] == "FileNotFoundError"
    assert got == _error(lambda: JaxImageFolder64(data_dir=str(tmp_path)).setup("fit"))


# ----------------------------------------------------------- the slice as a whole

def _tiny_config(name, root, data, model_args):
    """configs/<name>.yaml with TINY widths (f32, T = 20), ``root`` as its
    run directory and ``data`` over its data module's arguments."""
    cfg = tcfg.load_config(os.path.join(ROOT, "configs", name + ".yaml"))
    cfg["trainer"].update(max_steps=2, log_every_n_steps=1, default_root_dir=str(root))
    for cb in cfg["trainer"].get("callbacks") or []:
        cb["init_args"].update(imgsize=[3, 64, 64], num_samples=2, out_dir=str(root / "samples"))
    cfg["model"]["init_args"]["timesteps"] = 20
    cfg["model"]["init_args"]["model"]["init_args"].update(dtype="f32", **model_args)
    cfg["data"]["init_args"].update(data)
    return cfg


def _first_batch_loss_matches_jax(cfg, seed):
    """The data module's first batch at the run's seed (bitwise JAX's), then
    ``loss_given`` of the config's harness on seeded weights, t and ε in
    both packages."""
    tdm, jdm = tcfg.instantiate(cfg["data"]), jcfg.instantiate(cfg["data"])
    tdm.setup("fit")
    jdm.setup("fit")
    batch = _take(tdm.train_iter(seed), 1)[0]
    np.testing.assert_array_equal(batch, _take(jdm.train_iter(seed), 1)[0])
    x0 = tdm.process(torch.from_numpy(batch))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jdm.process(jnp.asarray(batch))))
    tlit, jlit = tcfg.instantiate(cfg["model"]), jcfg.instantiate(cfg["model"])
    assert tlit.model.remat and jlit.model.remat
    r = np.random.default_rng(seed)
    t = r.integers(2, 20, (x0.shape[0],))
    eps = r.standard_normal(tuple(x0.shape)).astype(np.float32)
    shapes = jax.eval_shape(jlit.model.init, jax.random.PRNGKey(0), jnp.asarray(x0.numpy()),
                            jnp.asarray(t, jnp.int32))

    def fill(path, leaf):
        scale = (1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if path[-1].key == "kernel" else 0.1)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * r.standard_normal(leaf.shape)).astype(np.float32)

    jparams = jax.tree_util.tree_map_with_path(fill, shapes)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jlit.diffusion_model.loss_given(
        jlit.model_fn, p, jnp.asarray(x0.numpy()), jnp.asarray(t, jnp.int32),
        jnp.asarray(eps))))(jparams)
    params = {k: v.requires_grad_(True) for k, v in from_flax(jparams).items()}
    tlit.model.load_state_dict(params, strict=True)
    got = tlit.diffusion_model.loss_given(tlit.model_fn, params, x0, torch.from_numpy(t),
                                          torch.from_numpy(eps))
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    grads = torch.autograd.grad(got, list(params.values()))
    want_grads = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), **GRAD_TOL, err_msg=k)


def _fit(cfg, tmp_path, capsys):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main(["fit", "--config", str(path)], device="cpu")
    err = capsys.readouterr().err
    assert "[step 2]" in err and "loss=" in err
    assert CheckpointManager(cfg["trainer"]["default_root_dir"]).latest_step() == 2
    return path


def test_lsun_church_tiny_fits_and_its_first_loss_matches_jax(tmp_path, capsys):
    """lsun_church.yaml's recipe at TINY widths on a synthetic LMDB of mixed
    sizes: batch 2, 4 accumulated microbatches, remat, the GenerateImage
    callback (64 px); the decode cache is written, and the first batch's
    loss and gradient are JAX's."""
    write_lmdb(str(tmp_path / "church_outdoor_train_lmdb"), _kv(12))
    cfg = _tiny_config("ddpm/lsun_church", tmp_path / "run",
                       dict(data_dir=str(tmp_path), imgsize=64, num_workers=2),
                       dict(channels_per_depth=[4, 8, 8, 8, 8, 8], pos_dim=4, emb_dim=8,
                            num_groups=2, num_blocks=1))
    cfg["trainer"]["accumulate_grad_batches"] = 4
    _fit(cfg, tmp_path, capsys)
    assert os.path.exists(tmp_path / "church_outdoor_train_decoded_64.npy")
    assert os.listdir(tmp_path / "run" / "samples")
    _first_batch_loss_matches_jax(cfg, cfg["seed_everything"])


def test_imagenet64_tiny_fits_without_its_mesh_and_its_first_loss_matches_jax(tmp_path,
                                                                             capsys):
    """imagenet64.yaml at TINY widths (4 heads, attention at depths 3 and 4,
    the hybrid loss on the cosine schedule) on a synthetic archive: with its
    own mesh ``fit`` raises naming A.11; with ``mesh: null`` it fits, and
    the first batch's loss and gradient are JAX's."""
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "train_data_batch_1.npz",
             data=_planar(rng.integers(0, 256, (16, 64, 64, 3), np.uint8)),
             labels=rng.integers(1, 1001, 16))
    cfg = _tiny_config("iddpm/imagenet64", tmp_path / "run",
                       dict(data_dir=str(tmp_path), batch_size=4),
                       dict(channels_per_depth=[8, 8, 16, 16], pos_dim=4, emb_dim=8,
                            num_groups=2, num_blocks=1))
    path = tmp_path / "with_mesh.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.11"):
        main(["fit", "--config", str(path)], device="cpu")
    cfg["trainer"]["mesh"] = None
    _fit(cfg, tmp_path, capsys)
    _first_batch_loss_matches_jax(cfg, cfg["seed_everything"])


@pytest.mark.parametrize("name,lr", [("bedroom", 2e-5), ("cat", 2e-4), ("church", 2e-5)])
def test_lsun_configs_read_their_learning_rate_as_a_float(name, lr):
    """``lr: 2e-5`` has no dot: YAML 1.1 (PyYAML, the JAX package's loader)
    reads a string, on which JAX's warmup schedule raises; the port's loader
    reads the float the config means."""
    path = os.path.join(ROOT, "configs", "ddpm", f"lsun_{name}.yaml")
    got = tcfg.load_config(path)["model"]["init_args"]["lr"]
    assert type(got) is float and got == lr
    assert jcfg.load_config(path)["model"]["init_args"]["lr"] == f"{lr:.0e}".replace("-0", "-")
    lit = tcfg.instantiate(dict(tcfg.load_config(path)["model"], init_args=dict(
        tcfg.load_config(path)["model"]["init_args"], model=None)))
    assert lit.make_optimizer().schedule(0) == pytest.approx(lr / 5000)
