"""Every constructor argument of the JAX package's config targets, in the port.

A config names a class by its JAX path; the port resolves it to its own
class (``config.resolve_class``) and validates the arguments against that
class's constructor, following ``**kwargs`` up the MRO
(``config.accepted_args``). This walks every JAX class the port resolves
(the harnesses, data modules, callbacks and loggers, the UNet, ADM and
DiT entries, and the guided samplers) and holds that each argument the JAX
constructor takes is taken by the port's or named, with its ROADMAP item,
in ``config._ARGS_NOT_PORTED``. It also holds the arguments that were
refused before (fault C.9): the MoE loss weights, ``CIFAR10(download=)``
and the UNets' ``param_dtype``, which of the repo's configs validate, and
that both ADM configs fit through the command line at TINY widths.
"""

import glob
import importlib
import inspect
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu_torch import config as tcfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX modules whose classes configs name, and the UNet entries
_MODULES = ("dmme_tpu.training", "dmme_tpu.data", "dmme_tpu.callbacks",
            "dmme_tpu.training.loggers")
_UNETS = ("dmme_tpu.models.ddpm.UNet", "dmme_tpu.models.iddpm.UNet",
          "dmme_tpu.models.unet.UNet")
#: the DiT entries (the module and its presets)
_DIT = ("dmme_tpu.models.dit.DiT", "dmme_tpu.models.dit.DiT_S", "dmme_tpu.models.dit.DiT_B",
        "dmme_tpu.models.dit.DiT_L")
#: the ADM entries (factories and modules) and the guided samplers
_ADM = ("dmme_tpu.models.adm.ADM", "dmme_tpu.models.adm.ADMG", "dmme_tpu.models.adm.ADMU",
        "dmme_tpu.models.adm.classifier", "dmme_tpu.models.adm.UNetModel",
        "dmme_tpu.models.adm.EncoderUNet", "dmme_tpu.diffusion.ClassifierGuidedDDPM",
        "dmme_tpu.diffusion.ClassifierGuidedDDIM")
#: flax's own module fields, not arguments of the model
_FLAX_FIELDS = {"parent", "name"}


def _jax_targets():
    paths = list(_UNETS) + list(_ADM) + list(_DIT)
    for name in _MODULES:
        mod = importlib.import_module(name)
        for attr in sorted(dir(mod)):
            obj = getattr(mod, attr)
            if (inspect.isclass(obj) and not attr.startswith("_")
                    and obj.__module__.startswith("dmme_tpu.")):
                paths.append(f"{name}.{attr}")
    out = []
    for path in paths:
        try:
            tcfg.resolve_class(path)
        except tcfg.ConfigError:
            continue  # not ported: the class itself names its item
        out.append(path)
    return out


def _jax_object(path):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


TARGETS = _jax_targets()


def test_the_walk_covers_the_ported_config_targets():
    for path in ("dmme_tpu.training.LitDDPM", "dmme_tpu.training.LitUpsampler",
                 "dmme_tpu.training.LitIDDPM", "dmme_tpu.training.LitClassifier",
                 "dmme_tpu.data.CIFAR10", "dmme_tpu.data.Shapes",
                 "dmme_tpu.callbacks.GenerateImage", "dmme_tpu.training.loggers.WandbLogger",
                 "dmme_tpu.training.LitDistill", *_UNETS, *_ADM, *_DIT):
        assert path in TARGETS


@pytest.mark.parametrize("path", TARGETS)
def test_every_jax_argument_is_taken_or_named(path):
    """Each argument of the JAX constructor (up its **kwargs chain) is taken
    by the port's or names its ROADMAP item."""
    want = tcfg.accepted_args(_jax_object(path))
    got = tcfg.accepted_args(tcfg.resolve_class(path))
    if want is None:  # any name (a logger's **kwargs for its backend)
        assert got is None, path
        return
    missing = want - _FLAX_FIELDS - (got if got is not None else want) - set(tcfg._ARGS_NOT_PORTED)
    assert not missing, f"{path}: the port neither takes nor names {sorted(missing)}"


def test_kwargs_harness_rejects_unknown_names():
    """A name that no constructor up a **kwargs harness's MRO takes is an
    unknown key at validation (it used to pass and die in a bare TypeError)."""
    config = tcfg.load_config(os.path.join(ROOT, "configs/ddim/cifar10.yaml"))
    config["model"]["init_args"]["not_an_argument"] = 1
    with pytest.raises(tcfg.ConfigError, match=r"unknown key\(s\) \['not_an_argument'\]"):
        tcfg.validate_config(config)


# --------------------------------------------------------- the C.9 cases

@pytest.mark.parametrize("path", ["configs/ddim/cifar10.yaml", "configs/flow/shapes_demo.yaml"])
def test_moe_weights_are_taken(path):
    config = tcfg.apply_overrides(tcfg.load_config(os.path.join(ROOT, path)),
                                  ["--model.init_args.moe_aux_weight=0.01",
                                   "--model.init_args.moe_z_weight=0.002"])
    lit = tcfg.instantiate(tcfg.validate_config(config)["model"])
    assert (lit.moe_aux_weight, lit.moe_z_weight) == (0.01, 0.002)


def test_moe_weight_leaves_a_router_free_loss_as_jax_does(monkeypatch):
    """JAX adds the router losses only where a model records them; the UNet
    records none, so at moe_aux_weight=0.01 its loss is the plain one. The
    port's loss on its draws equals JAX's ``loss_given`` on them."""
    from dmme_tpu.models import ddpm as jax_ddpm
    from dmme_tpu.training import LitDDPM as JaxLitDDPM
    from dmme_tpu_torch.diffusion import DDPM
    from dmme_tpu_torch.models import ddpm as t_ddpm
    from dmme_tpu_torch.training import LitDDPM
    from dmme_tpu_torch.utils.convert import from_flax

    tiny = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8),
                num_blocks=1, dropout=0.0)
    shape = (4, 8, 8, 3)
    jmodel = jax_ddpm.UNet(**tiny)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros(shape),
                                  jnp.zeros((4,), jnp.int32))
    x = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32))
    with_aux, without = (JaxLitDDPM(model=jmodel, timesteps=10, moe_aux_weight=w)
                         for w in (0.01, 0.0))
    rng = jax.random.PRNGKey(3)
    assert float(jax.jit(with_aux.make_loss_fn())(params, rng, x)) == float(
        jax.jit(without.make_loss_fn())(params, rng, x))

    tmodel = t_ddpm.UNet(**tiny)
    sd = from_flax(jax.tree.map(np.asarray, params))
    tmodel.load_state_dict(sd)
    lit = LitDDPM(model=tmodel, timesteps=10, moe_aux_weight=0.01)
    seen = {}
    orig = DDPM.loss_given

    def spy(self, model_fn, p, x0, t, noise, **kw):
        seen["t"], seen["noise"] = t, noise
        return orig(self, model_fn, p, x0, t, noise, **kw)

    monkeypatch.setattr(DDPM, "loss_given", spy)
    got = lit.make_loss_fn()(sd, torch.Generator().manual_seed(1), torch.tensor(np.asarray(x)))
    want = jax.jit(lambda p, t, noise: with_aux.diffusion_model.loss_given(
        with_aux.model_fn, p, x, t, noise))(params, jnp.asarray(seen["t"].numpy()),
                                            jnp.asarray(seen["noise"].numpy()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_cifar10_download_false_validates():
    config = tcfg.apply_overrides(
        tcfg.load_config(os.path.join(ROOT, "configs/ddpm/cifar10.yaml")),
        ["--data.init_args.download=false"])
    data = tcfg.instantiate(tcfg.validate_config(config)["data"])
    assert data.download is False
    data.prepare_data()  # a no-op, as in JAX


def test_cifar10_download_true_fetches_nothing(tmp_path, monkeypatch):
    """``download=True`` with the data absent raises naming the missing
    network, and opens no socket; with the data present, or synthetic, it
    is a no-op."""
    from dmme_tpu_torch.data import CIFAR10

    def no_socket(*a, **k):
        raise AssertionError("CIFAR10 tried to open a socket")

    monkeypatch.setattr(socket, "socket", no_socket)
    with pytest.raises(FileNotFoundError, match="downloads nothing.*network"):
        CIFAR10(data_dir=str(tmp_path), download=True).prepare_data()
    CIFAR10(data_dir=str(tmp_path), download=True, synthetic=True).prepare_data()
    (tmp_path / "cifar-10-batches-py").mkdir()
    CIFAR10(data_dir=str(tmp_path), download=True).prepare_data()


@pytest.mark.parametrize("factory", _UNETS)
def test_param_dtype_f32_only(factory):
    """f32 parameters are the port's own; any other ``param_dtype`` raises
    naming ROADMAP A.13, from the config as from the constructor."""
    small = {"channels_per_depth": [4, 8], "num_groups": 2, "pos_dim": 4, "emb_dim": 8}
    for value in ("float32", "f32"):
        model = tcfg.instantiate({"class_path": factory,
                                  "init_args": dict(small, param_dtype=value)})
        assert all(p.dtype == torch.float32 for p in model.parameters())
    tcfg.resolve_class(factory)(**small, param_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=r"param_dtype.*ROADMAP A\.13"):
        tcfg.instantiate({"class_path": factory, "init_args": dict(small, param_dtype="bf16")})


# --------------------------------------------------- the configs that validate

#: the repo's configs that the port validates, and the item each other waits for
VALIDATES = {"adm/cifar10_classifier", "adm/cifar10_guided", "ddim/cifar10", "ddpm/cifar10",
             "ddpm/cifar10_vpred", "ddpm/shapes256_demo", "ddpm/shapes_cfg_demo",
             "ddpm/shapes_demo", "ddpm/shapes_sr_demo", "edm/cifar10", "edm/shapes_demo",
             "flow/cifar10_dit", "flow/cifar10_dit_moe", "flow/shapes_demo",
             "flow/shapes_dit_demo", "flow/shapes_dit_moe_demo", "iddpm/cifar10",
             "iddpm/shapes64_demo", "iddpm/shapes_demo"}
WAITS = {"latent/shapes_latent_demo": "A.8",
         "latent/shapes_latent_flow_dit_demo": "A.8", "latent/shapes_vae_demo": "A.8",
         "ddpm/lsun_bedroom": "A.12", "ddpm/lsun_cat": "A.12", "ddpm/lsun_church": "A.12",
         "iddpm/imagenet64": "A.12"}


def test_thirteen_of_twenty_six_configs_validate():
    """Nineteen since the DiT configs (A.7) validate; the name is the one
    this test has had since thirteen did. The seven left wait for A.8 (3)
    and A.12 (4)."""
    names = sorted(os.path.relpath(p, os.path.join(ROOT, "configs"))[:-len(".yaml")]
                   for p in glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))
    assert len(names) == 26 and set(names) == VALIDATES | set(WAITS)
    assert len(VALIDATES) == 19 and not VALIDATES & set(WAITS)
    for name in names:
        config = tcfg.load_config(os.path.join(ROOT, "configs", name + ".yaml"))
        if name in VALIDATES:
            tcfg.validate_config(config)
            continue
        with pytest.raises(tcfg.ConfigError, match=rf"ROADMAP {WAITS[name]}\b"):
            tcfg.validate_config(config)


# ------------------------------------------------ the ADM configs on the command line

_TINY_ADM = ("model_channels: 32, channel_mult: [1, 2], num_res_blocks: 1, "
             "attention_resolutions: [16], num_head_channels: 16")
_ADM_ARGS = {
    "adm/cifar10_guided": ["--model.init_args.model.init_args",
                           "{image_size: 32, class_conditional: false, dtype: f32, "
                           f"{_TINY_ADM}}}"],
    "adm/cifar10_classifier": ["--model.init_args.dtype", "f32", "--model.init_args.model",
                               "{class_path: dmme_tpu.models.adm.classifier, init_args: "
                               f"{{image_size: 32, num_classes: 10, {_TINY_ADM}}}}}"],
}


@pytest.mark.parametrize("name", sorted(_ADM_ARGS))
def test_adm_config_fits_two_steps_on_the_cli(name, tmp_path, capsys):
    """``fit`` of each ADM config for 2 steps at TINY widths on synthetic
    CIFAR-10 (the classifier's labelled), through ``trainer.main``; the
    classifier config then refuses ``sample`` and ``serve``, which JAX's
    trainer cannot run on it either."""
    from dmme_tpu_torch import trainer
    from dmme_tpu_torch.training import CheckpointManager

    argv = ["--config", os.path.join(ROOT, "configs", name + ".yaml"),
            "--trainer.default_root_dir", str(tmp_path), "--trainer.max_steps", "2",
            "--trainer.log_every_n_steps", "1", "--model.init_args.timesteps", "10",
            "--data.init_args.synthetic", "true", "--data.init_args.synthetic_size", "16",
            "--data.init_args.batch_size", "4", *_ADM_ARGS[name]]
    trainer.main(["fit", *argv], device="cpu")
    err = capsys.readouterr().err
    assert "[step 2]" in err and "loss=" in err
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    if name == "adm/cifar10_classifier":
        for command in ("sample", "serve"):
            with pytest.raises(ValueError, match=rf"{command} needs a diffusion harness"):
                trainer.main([command, *argv], device="cpu")
