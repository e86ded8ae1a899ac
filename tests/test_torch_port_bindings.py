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

# (source, C function, module, binder, the module's cache of the binding,
# the binder's arguments): K3 and K4 bind one entry point per activation
# dtype, cached by dtype; K1 and K2 one for all three (a dtype code first),
# cached by name
BINDINGS = [
    ("group_norm", "dmme_gn_silu_fwd", t_group_norm, "_fwd_fn", "_FNS", ()),
    ("group_norm", "dmme_gn_silu_bwd", t_group_norm, "_bwd_fn", "_FNS", ()),
    ("attention", "dmme_attention_fwd", t_attention, "_fn", "_FNS", (torch.bfloat16,)),
    ("resblock", "dmme_resblock_fwd", t_resblock, "_fn", "_FNS", (torch.bfloat16,)),
    ("simt", "dmme_simt_gn_fwd", t_group_norm, "_simt_fwd_fn", "_FNS", ()),
    ("simt", "dmme_simt_gn_bwd", t_group_norm, "_simt_bwd_fn", "_FNS", ()),
    ("attention", "dmme_attention_fwd_f16", t_attention, "_fn", "_FNS", (torch.float16,)),
    ("attention", "dmme_attention_fwd_f32", t_attention, "_fn", "_FNS", (torch.float32,)),
    ("resblock", "dmme_resblock_fwd_f16", t_resblock, "_fn", "_FNS", (torch.float16,)),
    ("resblock", "dmme_resblock_fwd_f32", t_resblock, "_fn", "_FNS", (torch.float32,)),
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


@pytest.mark.parametrize("source,name,module,binder,cache,args", BINDINGS,
                         ids=[b[1] for b in BINDINGS])
def test_binding_matches_the_c_signature(monkeypatch, source, name, module, binder, cache, args):
    lib = _Lib()
    asked = []
    monkeypatch.setattr(build, "library", lambda src: asked.append(src) or lib)
    monkeypatch.setattr(module, cache, {} if isinstance(getattr(module, cache), dict) else None)
    fn = getattr(module, binder)(*args)
    assert asked == [source]
    assert fn.__name__ == name
    assert list(fn.argtypes) == c_params(source, name)
    assert fn.restype is ctypes.c_int
    assert getattr(module, binder)(*args) is fn and asked == [source]  # bound once


def test_each_dtype_binds_its_own_entry_point(monkeypatch):
    """K3 and K4 bind bf16, fp16 and f32 to three C functions, and raise for
    another dtype before any library is asked."""
    lib = _Lib()
    monkeypatch.setattr(build, "library", lambda src: lib)
    for module in (t_attention, t_resblock):
        monkeypatch.setattr(module, "_FNS", {})
        names = {module._fn(dt).__name__ for dt in (torch.bfloat16, torch.float16, torch.float32)}
        assert names == set(module.ENTRY.values()) and len(names) == 3
        with pytest.raises(KeyError):
            module._fn(torch.float64)


def test_dtype_codes_match_the_sources():
    """K1's, K2's and ``simt.cu``'s entry points take a dtype code first;
    the codes the wrappers pass (``ops.DTYPE_CODES``) are the ones each
    source's comment and switch name."""
    from dmme_tpu_torch.ops import DTYPE_CODES

    assert DTYPE_CODES == {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
    for source in ("group_norm", "simt"):
        text = (CSRC / f"{source}.cu").read_text()
        assert "0 f32, 1 fp16, 2 bf16" in text, source
    text = (CSRC / "group_norm.cu").read_text()
    for code, kind in ((0, "float"), (1, "__half"), (2, "bf16")):
        assert re.search(rf"case {code}:\s*return gn_fwd<{kind}>", text), kind
        assert re.search(rf"case {code}:\s*return gn_bwd<{kind}>", text), kind
