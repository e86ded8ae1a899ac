"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/dmme_tpu_torch/lib<name>-<hash>.so`` beside the package, where the
hash is that of the source text and of every local header it includes
(``#include "x.cuh"`` under ``csrc/``, followed recursively): an edited
source or header is rebuilt, an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits for
them together. No CUTLASS or CuTe header is used, so no include path is
added; TMA descriptors are encoded through the driver entry point that the
CUDA runtime hands out, so the libraries need no ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmme_tpu_torch"
SOURCES = ("attention", "group_norm", "resblock", "simt")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: the compiler's output of each source built by this process (``-Xptxas -v``
#: register and spill counts when :func:`build_all` ran with ``verbose``)
LOGS: Dict[str, str] = {}

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def local_includes(path: Path) -> List[Path]:
    """The files under ``csrc/`` that ``path`` includes with quotes, directly
    or through another of them, in the order first met."""
    seen: List[Path] = []
    todo = [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            dep = (CSRC / name).resolve()
            if dep.is_file() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for f in (src, *local_includes(src)):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every source whose library is missing (in parallel), then load
    them all. Raises with the compiler's output if any build fails."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if name in _LIBS or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        LOGS[name] = log
        if verbose and log:
            print(f"[nvcc {name}.cu]\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return {name: _LIBS[name] for name in names}


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per kernel (mangled name) of an ``-Xptxas -v`` log: registers a thread
    and spill bytes stored and loaded."""
    usage: Dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = usage.setdefault(m.group(1), {"registers": None, "spill_stores": 0,
                                                    "spill_loads": 0})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return usage


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of a CUDA device, asked of the driver once per device."""
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all((name,))
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
