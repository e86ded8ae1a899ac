"""Read-only LMDB file-format reader (mirrors ``dmme_tpu/data/lmdb_reader.py``).

LSUN ships as LMDB environments. No ``lmdb`` package is needed: this module
reads the on-disk format directly (LMDB 0.9 data format, little-endian
64-bit): meta-page selection by txnid, B+tree traversal of the main DB,
node parsing, and overflow-page reassembly. mmap-backed: ``get`` and
iteration return zero-copy ``memoryview`` slices. Pure host Python; the
same walk in C++ (``dmme_tpu_torch/native/lmdb_scan.cc``) backs
:class:`NativeLMDBReader`, and :func:`open_lmdb` takes it where ``g++``
built it. ``backend`` names the implementation of a reader.

Format notes (mdb.c):
* two meta pages (pgno 0/1); the live one has the larger ``mm_txnid``;
  the page size is stashed in ``mm_dbs[FREE_DBI].md_pad``.
* page header = 16 bytes: pgno u64, pad u16, flags u16, lower u16, upper u16
  (for overflow pages the u32 at offset 12 is the page count).
* node: lo u16, hi u16, flags u16, ksize u16, key bytes, data. Leaf data
  size = lo | hi<<16 (F_BIGDATA ⇒ data is a u64 overflow pgno); branch child
  pgno = lo | hi<<16 | flags<<32.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01

_PAGEHDR = 16
_INVALID = 0xFFFFFFFFFFFFFFFF


class LMDBError(RuntimeError):
    pass


class LMDBReader:
    """Read-only access to an LMDB environment's main database."""

    backend = "python"

    def __init__(self, path: str):
        data_path = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self._file = open(data_path, "rb")
        self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._load_meta()

    # ------------------------------------------------------------------ meta
    def _parse_meta(self, off: int):
        magic, version = struct.unpack_from("<II", self._map, off + _PAGEHDR)
        if magic != MDB_MAGIC:
            raise LMDBError(f"bad LMDB magic at offset {off:#x}: {magic:#x}")
        base = off + _PAGEHDR + 8 + 8 + 8  # magic+version, mm_address, mm_mapsize
        free_db = struct.unpack_from("<IHHQQQQQ", self._map, base)
        main_db = struct.unpack_from("<IHHQQQQQ", self._map, base + 48)
        last_pg, txnid = struct.unpack_from("<QQ", self._map, base + 96)
        return {
            "psize": free_db[0],
            "main_root": main_db[7],
            "entries": main_db[6],
            "depth": main_db[2],
            "txnid": txnid,
        }

    def _load_meta(self) -> None:
        m0 = self._parse_meta(0)
        psize = m0["psize"] or 4096
        m1 = self._parse_meta(psize)
        meta = m0 if m0["txnid"] >= m1["txnid"] else m1
        self.psize = psize
        self.root = meta["main_root"]
        self.entries = meta["entries"]

    # ----------------------------------------------------------------- pages
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self._map, off + 10)[0]

    def _numkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._map, off + 12)[0]
        return (lower - _PAGEHDR) >> 1

    def _node_off(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._map, page_off + _PAGEHDR + 2 * i)[0]
        return page_off + ptr

    def _node(self, page_off: int, i: int):
        off = self._node_off(page_off, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._map, off)
        key = self._map[off + 8 : off + 8 + ksize]
        return lo, hi, flags, ksize, key, off

    def _branch_child(self, page_off: int, i: int) -> int:
        lo, hi, flags, _, _, _ = self._node(page_off, i)
        return lo | (hi << 16) | (flags << 32)

    def _leaf_value(self, page_off: int, i: int) -> memoryview:
        lo, hi, flags, ksize, _, off = self._node(page_off, i)
        size = lo | (hi << 16)
        if flags & F_BIGDATA:
            (ov_pgno,) = struct.unpack_from("<Q", self._map, off + 8 + ksize)
            start = self._page(ov_pgno) + _PAGEHDR
            return memoryview(self._map)[start : start + size]
        start = off + 8 + ksize
        return memoryview(self._map)[start : start + size]

    # ------------------------------------------------------------------- API
    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[Tuple[bytes, memoryview]]:
        """In-order (key, value) iteration over the whole main DB."""
        if self.root == _INVALID:
            return
        stack = [self._page(self.root)]
        # depth-first, but branches push children reversed to keep key order
        while stack:
            off = stack.pop()
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_LEAF:
                if flags & P_LEAF2:
                    raise LMDBError("MDB_DUPFIXED (LEAF2) pages not supported")
                for i in range(n):
                    _, _, _, _, key, _ = self._node(off, i)
                    yield bytes(key), self._leaf_value(off, i)
            elif flags & P_BRANCH:
                for i in reversed(range(n)):
                    stack.append(self._page(self._branch_child(off, i)))
            elif flags & P_OVERFLOW:
                raise LMDBError("dangling overflow page in tree walk")
            else:
                raise LMDBError(f"unexpected page flags {flags:#x}")

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def get(self, key: bytes) -> Optional[memoryview]:
        """Binary-search lookup (memcmp key order)."""
        if self.root == _INVALID:
            return None
        off = self._page(self.root)
        while True:
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, _, _, _, k, _ = self._node(off, mid)
                    kb = bytes(k)
                    if kb == key:
                        return self._leaf_value(off, mid)
                    if kb < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: find rightmost child whose key <= target (node 0 has
            # an implicit -inf key)
            idx = 0
            for i in range(1, n):
                _, _, _, _, k, _ = self._node(off, i)
                if bytes(k) <= key:
                    idx = i
                else:
                    break
            off = self._page(self._branch_child(off, idx))

    def close(self) -> None:
        self._map.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeLMDBReader:
    """Same API as :class:`LMDBReader`, backed by the C++ walker
    (``dmme_tpu_torch/native/lmdb_scan.cc``) via ctypes. Iteration returns
    zero-copy memoryviews into the mmap held by the native env."""

    backend = "native"

    def __init__(self, path: str):
        import ctypes

        from dmme_tpu_torch.native import load_lmdb_native

        lib = load_lmdb_native()
        if lib is None:
            raise LMDBError("native lmdb backend unavailable")
        self._lib = lib
        self._ct = ctypes
        self._env = lib.lmdb_open(path.encode())
        if not self._env:
            raise LMDBError(f"cannot open LMDB at {path}")
        self.entries = lib.lmdb_entries(self._env)

    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[Tuple[bytes, memoryview]]:
        ct = self._ct
        it = self._lib.lmdb_iter_new(self._env)
        key_p = ct.POINTER(ct.c_uint8)()
        val_p = ct.POINTER(ct.c_uint8)()
        klen = ct.c_uint64()
        vlen = ct.c_uint64()
        try:
            while self._lib.lmdb_iter_next(
                it, ct.byref(key_p), ct.byref(klen), ct.byref(val_p), ct.byref(vlen)
            ):
                key = ct.string_at(key_p, klen.value)
                val = memoryview(
                    (ct.c_uint8 * vlen.value).from_address(
                        ct.addressof(val_p.contents)
                    )
                ).cast("B")
                yield key, val
        finally:
            self._lib.lmdb_iter_free(it)

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def get(self, key: bytes) -> Optional[memoryview]:
        ct = self._ct
        val_p = ct.POINTER(ct.c_uint8)()
        vlen = ct.c_uint64()
        buf = (ct.c_uint8 * len(key)).from_buffer_copy(key)
        if not self._lib.lmdb_get(
            self._env, buf, len(key), ct.byref(val_p), ct.byref(vlen)
        ):
            return None
        return memoryview(
            (ct.c_uint8 * vlen.value).from_address(ct.addressof(val_p.contents))
        ).cast("B")

    def close(self) -> None:
        if self._env:
            self._lib.lmdb_close(self._env)
            self._env = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_lmdb(path: str, prefer_native: bool = True):
    """Best-available reader: the C++ backend when g++/ctypes work, else the
    pure-Python implementation (identical API and semantics; host parsing
    either way). The reader's ``backend`` says which one it is."""
    if prefer_native:
        try:
            return NativeLMDBReader(path)
        except LMDBError:
            pass
    return LMDBReader(path)
