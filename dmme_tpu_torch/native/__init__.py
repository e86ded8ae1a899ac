"""Native (C++) host components, bound via ctypes (mirrors ``dmme_tpu.native``).

Currently: the LMDB data-file walker (``lmdb_scan.cc``, the port's own copy)
used by :mod:`dmme_tpu_torch.data.lmdb_reader` when available. The shared
library is built on first use with the system ``g++`` into
``build/dmme_tpu_torch/liblmdb_scan-<hash>.so`` beside the package (the hash
is the source's, as ``ops/build.py`` names its libraries), never next to the
source. Concurrent builds (test workers, several processes of one host)
each write a temporary file and ``os.replace`` it into place. Without a
compiler :func:`load_lmdb_native` returns None and the readers fall back to
the pure-Python implementation: the same host parsing and results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "lmdb_scan.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmme_tpu_torch"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source lives once built."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"liblmdb_scan-{digest}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_lmdb_native() -> Optional[ctypes.CDLL]:
    """The compiled library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.lmdb_open.restype = ctypes.c_void_p
        lib.lmdb_open.argtypes = [ctypes.c_char_p]
        lib.lmdb_close.restype = None
        lib.lmdb_close.argtypes = [ctypes.c_void_p]
        lib.lmdb_entries.restype = ctypes.c_uint64
        lib.lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.lmdb_iter_new.restype = ctypes.c_void_p
        lib.lmdb_iter_new.argtypes = [ctypes.c_void_p]
        lib.lmdb_iter_next.restype = ctypes.c_int
        lib.lmdb_iter_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lmdb_iter_free.restype = None
        lib.lmdb_iter_free.argtypes = [ctypes.c_void_p]
        lib.lmdb_get.restype = ctypes.c_int
        lib.lmdb_get.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        _lib = lib
        return _lib
