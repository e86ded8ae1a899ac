"""YAML configs: ``class_path``/``init_args`` trees (mirrors ``dmme_tpu/config.py``).

Any mapping with a ``class_path`` is resolved and built with its
(recursively built) ``init_args``; dotted overrides (``--model.init_args.lr
1e-4``) rewrite the tree first, and :func:`validate_config` rejects unknown
keys anywhere in it before anything is built.

The repo's YAML names the JAX package's classes (``dmme_tpu.…``). Such a
path resolves to the same path under ``dmme_tpu_torch.``, so the configs
run unedited; the JAX package is never imported. A class or argument the
port does not have yet raises :class:`ConfigError` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, List, Optional, Set

import yaml

from dmme_tpu_torch.training.lit import resolve_dtype

#: what the port has not ported yet, by JAX class path (or its prefix), with
#: the ROADMAP item that ports it
_NOT_PORTED = {
    "dmme_tpu.training.LitVAE": "A.8: latent diffusion",
    "dmme_tpu.training.LitLatentDDPM": "A.8: latent diffusion",
    "dmme_tpu.training.LitLatentFlow": "A.8: latent diffusion",
    "dmme_tpu.models.vae": "A.8: latent diffusion",
    "dmme_tpu.data.LSUN": "A.12: LSUN and the remaining data",
    "dmme_tpu.data.ImageFolder64": "A.12: LSUN and the remaining data",
}
#: constructor arguments of ported classes that only the JAX package takes
#: yet, with the ROADMAP item that ports them (none at present)
_ARGS_NOT_PORTED: Dict[str, str] = {}


class ConfigError(ValueError):
    """Unknown key, bad structure or a class not ported, in a config tree."""


def _item(jax_path: str) -> str:
    for prefix, item in _NOT_PORTED.items():
        if jax_path == prefix or jax_path.startswith(prefix + "."):
            return item
    return "queue A"


def resolve_class(class_path: str):
    """The port's class for ``class_path``; ``dmme_tpu.x`` reads
    ``dmme_tpu_torch.x``. Raises :class:`ConfigError` for a class the port
    lacks."""
    jax_path = class_path
    if class_path.startswith("dmme_tpu."):
        class_path = "dmme_tpu_torch." + class_path[len("dmme_tpu."):]
    module, _, name = class_path.rpartition(".")
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if not (e.name and module.startswith(e.name)):
            raise  # a dependency of an existing module is missing: not ours to rename
        raise ConfigError(f"{jax_path}: not ported to dmme_tpu_torch yet "
                          f"(ROADMAP {_item(jax_path)})") from None
    try:
        return getattr(mod, name)
    except AttributeError:
        raise ConfigError(f"{jax_path}: not ported to dmme_tpu_torch yet "
                          f"(ROADMAP {_item(jax_path)})") from None


def instantiate(node: Any) -> Any:
    """Recursively build ``{class_path, init_args}`` nodes."""
    if isinstance(node, dict):
        if "class_path" in node:
            cls = resolve_class(node["class_path"])
            kwargs = {k: instantiate(v) for k, v in (node.get("init_args") or {}).items()}
            return cls(**_canon_kwargs(kwargs))
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def _canon_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """A ``dtype`` or ``param_dtype`` name (``bf16``, ``fp32``/``f32``,
    ``fp16``, …) as the torch dtype."""
    out = dict(kwargs)
    for key in ("dtype", "param_dtype"):
        if isinstance(out.get(key), str):
            out[key] = resolve_dtype(out[key])
    return out


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_overrides(config: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``key.path=value`` / ``--key.path value`` overrides; values are YAML."""
    i = 0
    while i < len(overrides):
        item = overrides[i]
        if item.startswith("--"):
            item = item[2:]
        if "=" in item:
            key, value = item.split("=", 1)
            i += 1
        else:
            key = item
            i += 1
            if i >= len(overrides):
                raise ValueError(f"missing value for override {key!r}")
            value = overrides[i]
            i += 1
        _set_dotted(config, key, _parse_value(value))
    return config


def _parse_value(text: str) -> Any:
    value = yaml.safe_load(text)
    if isinstance(value, str):
        # YAML 1.1 does not read "2e-4" as a float
        for conv in (int, float):
            try:
                return conv(value)
            except ValueError:
                pass
    return value


def _set_dotted(config: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = config
    for k in keys[:-1]:
        child = node.get(k)
        if child is None:
            # through a `key: null` (the configs' `mesh: null`): make the mapping
            child = {}
            node[k] = child
        elif not isinstance(child, dict):
            # a scalar or list on the way means a typo; replacing it would lose the value
            raise ConfigError(f"cannot apply override {dotted!r}: {k!r} holds a "
                              f"{type(child).__name__}, not a mapping")
        node = child
    node[keys[-1]] = value


# --- strict validation: unknown keys anywhere in the tree fail before any work

TOP_LEVEL_KEYS = frozenset({"seed_everything", "trainer", "model", "data", "ckpt_path"})

TRAINER_KEYS = frozenset({
    # fit
    "max_steps", "log_every_n_steps", "ckpt_every_n_steps",
    "default_root_dir", "accumulate_grad_batches", "mesh", "callbacks",
    "resume", "max_restarts", "steps_per_call", "detect_anomaly",
    "ckpt_max_to_keep", "ckpt_step",
    "tensorboard", "loggers",
    # evaluate / sample / predict / serve
    "limit_test_batches", "limit_val_batches", "limit_predict_batches",
    "inception_weights", "fid_stats", "save_fid_stats", "use_ema",
    "sampler", "sample_steps", "refresh_interval", "cache_depth",
    "img_size", "sample_batch", "predict_batch", "host", "port",
})

MESH_KEYS = frozenset({"data", "fsdp", "tensor", "spatial", "expert"})


def _fail_unknown(unknown, where: str, known) -> None:
    raise ConfigError(f"unknown key(s) {sorted(unknown)} in {where}; known keys: {sorted(known)}")


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Reject unknown keys, bad structure and classes not ported; returns config."""
    if not isinstance(config, dict):
        raise ConfigError(f"config root must be a mapping, got {type(config)}")
    unknown = set(config) - TOP_LEVEL_KEYS
    if unknown:
        _fail_unknown(unknown, "top-level config", TOP_LEVEL_KEYS)
    trainer = config.get("trainer") or {}
    if not isinstance(trainer, dict):
        raise ConfigError("trainer: must be a mapping")
    unknown = set(trainer) - TRAINER_KEYS
    if unknown:
        _fail_unknown(unknown, "trainer:", TRAINER_KEYS)
    mesh = trainer.get("mesh") or {}
    if mesh:
        if not isinstance(mesh, dict):
            raise ConfigError("trainer.mesh: must be a mapping of axis sizes")
        unknown = set(mesh) - MESH_KEYS
        if unknown:
            _fail_unknown(unknown, "trainer.mesh:", MESH_KEYS)
    for slot in ("model", "data"):
        if config.get(slot) is not None:
            if not isinstance(config[slot], dict) or "class_path" not in config[slot]:
                raise ConfigError(f"{slot}: must be a mapping with a class_path "
                                  f"(got {type(config[slot]).__name__})")
            _validate_class_tree(config[slot], slot)
    for slot in ("callbacks", "loggers"):
        nodes = trainer.get(slot)
        if nodes is None:
            continue
        if not isinstance(nodes, list):
            raise ConfigError(f"trainer.{slot}: must be a LIST of class_path entries "
                              f"(got {type(nodes).__name__})")
        for i, node in enumerate(nodes):
            if not isinstance(node, dict) or "class_path" not in node:
                # a bare string would pass through instantiate() unbuilt and never run
                raise ConfigError(f"trainer.{slot}[{i}]: must be a mapping with a "
                                  f"class_path (got {type(node).__name__})")
            _validate_class_tree(node, f"trainer.{slot}[{i}]")
    return config


def _validate_class_tree(node: Any, where: str) -> None:
    if isinstance(node, dict):
        if "class_path" in node:
            extra = set(node) - {"class_path", "init_args"}
            if extra:
                _fail_unknown(extra, where, {"class_path", "init_args"})
            cls = resolve_class(node["class_path"])  # loud on a bad or unported path
            init_args = node.get("init_args") or {}
            if not isinstance(init_args, dict):
                raise ConfigError(f"{where}.init_args must be a mapping")
            _check_signature(cls, init_args, where)
            for k, v in init_args.items():
                _validate_class_tree(v, f"{where}.init_args.{k}")
        else:
            for k, v in node.items():
                _validate_class_tree(v, f"{where}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _validate_class_tree(v, f"{where}[{i}]")


def accepted_args(target) -> Optional[Set[str]]:
    """The keyword arguments a class (or factory function) takes: its own,
    and, where its constructor passes ``**kwargs`` on, those of the base
    classes' constructors up the MRO to the first without ``**kwargs``.
    None where any name would do or there is no introspectable signature."""
    inits = ([c.__dict__["__init__"] for c in target.__mro__ if "__init__" in c.__dict__]
             if inspect.isclass(target) else [target])
    names: Set[str] = set()
    for init in inits:
        try:
            params = inspect.signature(init).parameters
        except (TypeError, ValueError):
            return None
        names |= {n for n, p in params.items() if n != "self" and p.kind not in (
            inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)}
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return names
    return None  # **kwargs all the way up


def _check_signature(cls, init_args: Dict[str, Any], where: str) -> None:
    names = accepted_args(cls)
    if names is None:
        return
    unknown = set(init_args) - names
    if unknown:
        items = sorted({_ARGS_NOT_PORTED[k] for k in unknown if k in _ARGS_NOT_PORTED})
        if items:
            raise ConfigError(f"{where}.init_args {sorted(unknown)} for {cls.__name__}: not "
                              f"ported to dmme_tpu_torch yet (ROADMAP {', '.join(items)})")
        _fail_unknown(unknown, f"{where}.init_args for {cls.__name__}", names)


def describe_class(class_path: str) -> str:
    """One line per constructor argument: the body of the CLI's ``--help``."""
    cls = resolve_class(class_path)
    try:
        sig = inspect.signature(cls)
    except (TypeError, ValueError):
        return f"{class_path}: (no introspectable signature)"
    lines = [f"{class_path}:"]
    for name, p in sig.parameters.items():
        if p.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            lines.append(f"  {p}")
            continue
        ann = ("" if p.annotation is inspect.Parameter.empty
               else f": {inspect.formatannotation(p.annotation)}")
        default = ("  (required)" if p.default is inspect.Parameter.empty
                   else f" = {p.default!r}")
        lines.append(f"  {name}{ann}{default}")
    return "\n".join(lines)
