"""The ctypes bindings of the port's CUDA entry points against their C
signatures in ``dmme_tpu_torch/ops/csrc/*.cu``.

Nothing is compiled here (the CPU has no ``nvcc``): each binder is run on a
stand-in library, and the ``argtypes`` it sets are held against the
parameter list parsed from the source. A pointer or an int passed where the
other is declared would be cut or misread on the card without an error."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from dmme_tpu_torch.ops import attention as t_attention
from dmme_tpu_torch.ops import build
from dmme_tpu_torch.ops import group_norm as t_group_norm
from dmme_tpu_torch.ops import resblock as t_resblock

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent / "csrc"

# (source, C function, module, binder, the module's cache of the binding)
BINDINGS = [
    ("group_norm", "dmme_gn_silu_fwd", t_group_norm, "_fwd_fn", "_FWD"),
    ("group_norm", "dmme_gn_silu_bwd", t_group_norm, "_bwd_fn", "_BWD"),
    ("attention", "dmme_attention_fwd", t_attention, "_fn", "_FN"),
    ("resblock", "dmme_resblock_fwd", t_resblock, "_fn", "_FN"),
    ("simt", "dmme_simt_gn_fwd", t_group_norm, "_simt_fwd_fn", "_SIMT_FWD"),
    ("simt", "dmme_simt_gn_bwd", t_group_norm, "_simt_bwd_fn", "_SIMT_BWD"),
    ("simt", "dmme_simt_attention", t_attention, "_simt_fn", "_SIMT"),
    ("simt", "dmme_simt_resblock", t_resblock, "_simt_fn", "_SIMT"),
]


def c_params(source: str, name: str):
    """The ctypes type each parameter of C function ``name`` takes."""
    text = (CSRC / f"{source}.cu").read_text()
    m = re.search(rf"\bint\s+{name}\s*\(([^)]*)\)\s*\{{", text)
    assert m, f"{name} not found in {source}.cu"
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            kinds.append(ctypes.c_void_p)
        elif decl.startswith("long long"):
            kinds.append(ctypes.c_longlong)
        elif decl.startswith("float"):
            kinds.append(ctypes.c_float)
        elif decl.startswith("int"):
            kinds.append(ctypes.c_int)
        else:
            raise AssertionError(f"{name}: unexpected parameter {decl!r}")
    return kinds


class _Lib:
    """A stand-in library whose functions keep what a binder sets."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        fn.__name__ = name
        self.__dict__[name] = fn
        return fn


def test_every_source_is_built():
    assert sorted(build.SOURCES) == sorted(p.stem for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("source,name,module,binder,cache", BINDINGS,
                         ids=[b[1] for b in BINDINGS])
def test_binding_matches_the_c_signature(monkeypatch, source, name, module, binder, cache):
    lib = _Lib()
    asked = []
    monkeypatch.setattr(build, "library", lambda src: asked.append(src) or lib)
    monkeypatch.setattr(module, cache, None)
    fn = getattr(module, binder)()
    assert asked == [source]
    assert fn.__name__ == name
    assert list(fn.argtypes) == c_params(source, name)
    assert fn.restype is ctypes.c_int
