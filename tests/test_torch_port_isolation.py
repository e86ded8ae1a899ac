"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports ``dmme_tpu_torch`` and every submodule and must
leave ``jax`` and ``dmme_tpu`` out of ``sys.modules``; and no import
statement under ``dmme_tpu_torch/`` or in ``chip_smoke.py`` names ``jax``,
``flax``, ``optax``, ``orbax`` or ``dmme_tpu``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dmme_tpu")

_PROBE = """
import importlib, pkgutil, sys
import dmme_tpu_torch
for m in pkgutil.walk_packages(dmme_tpu_torch.__path__, "dmme_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
print("LOADED", ",".join(sorted(n for n in sys.modules if n.startswith("dmme_tpu_torch"))))
print("BAD", bad)
"""


def test_import_leaves_jax_out_of_sys_modules():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    loaded = set(lines["LOADED"].split(","))
    # every module of the package was imported, the training slice's included
    for path in (ROOT / "dmme_tpu_torch").rglob("*.py"):
        parts = path.relative_to(ROOT).with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        assert name in loaded, name
    assert {"dmme_tpu_torch.training.loop", "dmme_tpu_torch.parallel.train_step",
            "dmme_tpu_torch.data.cifar10", "dmme_tpu_torch.training.optimizer"} <= loaded
    assert lines["BAD"] == "[]"


def _sources():
    files = sorted((ROOT / "dmme_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_names_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
