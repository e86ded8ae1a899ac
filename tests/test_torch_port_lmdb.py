"""The port's LMDB readers against the JAX package's, on the files
``tests/lmdb_fixture.py`` writes.

Every case of tests/test_lsun.py::TestLMDBReader and
tests/test_native_lmdb.py runs on the port's pure-Python and native
(C++) readers against JAX's pure-Python ``LMDBReader`` (its native reader
is not used: its loader writes ``dmme_tpu/native/liblmdb_scan.so``):
entries, every (key, value) in order, and point lookups, byte for byte. The
port's native library is built under ``build/dmme_tpu_torch/`` with its
source hash and never beside either package's source.
"""

import os
import re
import struct
import threading
import time

import numpy as np
import pytest

from dmme_tpu.data.lmdb_reader import LMDBError as JaxLMDBError
from dmme_tpu.data.lmdb_reader import LMDBReader as JaxReader
from dmme_tpu_torch import native
from dmme_tpu_torch.data import lmdb_reader as tl
from tests.lmdb_fixture import PAGEHDR, PSIZE, write_lmdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = {"python": tl.LMDBReader, "native": tl.NativeLMDBReader}


def _kv_small():
    return {f"k{i:03d}".encode(): f"value-{i}".encode() for i in range(10)}


def _kv_overflow():
    rng = np.random.default_rng(1)
    return {b"big": rng.bytes(10_000), b"small": b"x"}


def _kv_tree():
    return {f"key{i:04d}".encode(): f"v{i}".encode() for i in range(50)}


def _kv_native_case():
    rng = np.random.default_rng(2)
    kv = {f"key{i:05d}".encode(): rng.bytes(60 + i % 50) for i in range(200)}
    kv[b"huge"] = rng.bytes(20_000)  # overflow pages
    return kv


def _kv_large():
    return {f"k{i:06d}".encode(): bytes(50) for i in range(5000)}


# (name, key-values, leaf_split, keys looked up, keys missing)
CASES = [
    ("single_leaf", _kv_small, 0, [b"k003", b"k000", b"k009"], [b"missing"]),
    ("overflow", _kv_overflow, 0, [b"big", b"small"], [b"bigger"]),
    ("branch_tree", _kv_tree, 10, [b"key0000", b"key0009", b"key0010", b"key0049"],
     [b"key9999", b"a"]),
    ("native_case", _kv_native_case, 20, [b"key00000", b"key00199", b"huge"], [b"nope"]),
    ("large_scan", _kv_large, 40, [b"k000000", b"k002500", b"k004999"], [b"k005000"]),
]


@pytest.mark.parametrize("kind", READERS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_reader_matches_jax(tmp_path, kind, case):
    name, make, leaf_split, hits, misses = case
    kv = make()
    path = str(tmp_path / f"{name}.mdb")
    write_lmdb(path, kv, leaf_split=leaf_split)
    with READERS[kind](path) as got, JaxReader(path) as want:
        assert got.backend == kind
        assert len(got) == len(want) == len(kv)
        items = [(k, bytes(v)) for k, v in got.items()]
        assert items == [(k, bytes(v)) for k, v in want.items()] == sorted(kv.items())
        assert list(got.keys()) == sorted(kv)
        for k in hits:
            assert bytes(got.get(k)) == bytes(want.get(k)) == kv[k]
        for k in misses:
            assert got.get(k) is None and want.get(k) is None


@pytest.mark.parametrize("kind", READERS)
def test_meta_selection_uses_latest_txn(tmp_path, kind):
    """The stale meta page (txnid 1) has no root; the live one (txnid 2) has
    the entry. Swapping the txnids makes the empty meta the live one."""
    path = str(tmp_path / "meta.mdb")
    write_lmdb(path, {b"a": b"1"})
    with READERS[kind](path) as got, JaxReader(path) as want:
        assert len(got) == len(want) == 1
        assert bytes(got.get(b"a")) == b"1"
    txnid_at = PAGEHDR + 8 + 16 + 48 + 48 + 8  # magic+version, address+mapsize, 2 dbs, last_pg
    with open(path, "r+b") as f:
        for page, txnid in ((0, 3), (1, 2)):
            f.seek(page * PSIZE + txnid_at)
            f.write(struct.pack("<Q", txnid))
    with READERS[kind](path) as got, JaxReader(path) as want:
        assert len(got) == len(want) == 0
        assert list(got.items()) == list(want.items()) == []


def test_leaf2_pages_are_refused_as_jax_refuses_them(tmp_path):
    """MDB_DUPFIXED (LEAF2) pages: both Python readers raise the same
    error; the native walker ends its iteration there."""
    path = str(tmp_path / "leaf2.mdb")
    write_lmdb(path, _kv_small())
    with open(path, "r+b") as f:  # the root leaf (page 2) gets P_LEAF2 too
        f.seek(2 * PSIZE + 10)
        f.write(struct.pack("<H", 0x02 | 0x20))
    with JaxReader(path) as reader, pytest.raises(JaxLMDBError) as want:
        list(reader.items())
    with tl.LMDBReader(path) as reader, pytest.raises(tl.LMDBError) as got:
        list(reader.items())
    assert str(got.value) == str(want.value) == "MDB_DUPFIXED (LEAF2) pages not supported"
    with tl.NativeLMDBReader(path) as reader:
        assert list(reader.items()) == []


def test_open_lmdb_prefers_native_and_falls_back(tmp_path, monkeypatch):
    path = str(tmp_path / "t2.mdb")
    write_lmdb(path, {b"a": b"1"})
    with tl.open_lmdb(path) as r:
        assert isinstance(r, tl.NativeLMDBReader) and r.backend == "native"
    with tl.open_lmdb(path, prefer_native=False) as r:
        assert type(r) is tl.LMDBReader and r.backend == "python"
    monkeypatch.setattr(native, "load_lmdb_native", lambda: None)  # no compiler
    with tl.open_lmdb(path) as r:
        assert type(r) is tl.LMDBReader and bytes(r.get(b"a")) == b"1"


def test_native_library_lands_under_build_with_its_hash():
    assert native.load_lmdb_native() is not None
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert str(native.BUILD_DIR) == os.path.join(ROOT, "build", "dmme_tpu_torch")
    assert re.fullmatch(r"liblmdb_scan-[0-9a-f]{12}\.so", path.name)
    assert path.exists() and native.load_lmdb_native()._name == str(path)
    assert native.SRC == native.BUILD_DIR.parents[1] / "dmme_tpu_torch" / "native" / "lmdb_scan.cc"


def _jax_library_state(path):
    """(exists, mtime in ns) of the JAX package's library, once no build of
    it can still be running: JAX's own loader (this process's or another
    test worker's) writes it, never the port."""
    from dmme_tpu.native import load_lmdb_native as jax_load

    jax_load()
    for _ in range(50):  # a concurrent JAX build takes ≈ 1 s; wait until it is old
        if not os.path.exists(path) or time.time() - os.path.getmtime(path) > 5:
            break
        time.sleep(0.2)
    return os.path.exists(path), os.path.exists(path) and os.stat(path).st_mtime_ns


def test_the_port_never_writes_the_jax_library(tmp_path, monkeypatch):
    """A fresh build and use of the port's scanner (into an empty build
    directory) leaves ``dmme_tpu/native/liblmdb_scan.so`` as it found it."""
    jax_lib = os.path.join(ROOT, "dmme_tpu", "native", "liblmdb_scan.so")
    before = _jax_library_state(jax_lib)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    db = str(tmp_path / "db.mdb")
    write_lmdb(db, _kv_tree(), leaf_split=10)
    with tl.open_lmdb(db) as r:
        assert r.backend == "native" and len(list(r.items())) == 50
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [native.library_path().name]
    assert (os.path.exists(jax_lib), os.path.exists(jax_lib) and os.stat(jax_lib).st_mtime_ns) \
        == before


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Builders racing on one target (test workers, processes of a host)
    each compile to a temporary name and ``os.replace`` it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out = native.library_path()
    results = []
    threads = [threading.Thread(target=lambda: results.append(native._build(out)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and results == [True] * 4
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load_lmdb_native()._name == str(out)
