"""The port's config system and command line against the JAX package's.

The repo's YAML names the JAX package's classes; the port resolves them to
its own, accepts exactly the shipped configs whose classes it has, builds
them with the JAX package's hyperparameters, and rejects what the JAX
package's strict validation rejects. The subcommands run a TINY config on
the CPU through ``main(argv, device="cpu")``.
"""

import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from dmme_tpu_torch import config as tcfg
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.trainer import main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(os.path.relpath(p, ROOT)
                 for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
#: the shipped configs whose every class (and argument) the port has
PORTED = {"configs/ddpm/cifar10.yaml", "configs/ddim/cifar10.yaml",
          "configs/ddpm/cifar10_vpred.yaml", "configs/ddpm/shapes_demo.yaml",
          "configs/ddpm/shapes256_demo.yaml", "configs/iddpm/cifar10.yaml",
          "configs/iddpm/shapes_demo.yaml", "configs/iddpm/shapes64_demo.yaml",
          "configs/edm/cifar10.yaml", "configs/edm/shapes_demo.yaml",
          "configs/flow/shapes_demo.yaml", "configs/ddpm/shapes_cfg_demo.yaml",
          "configs/ddpm/shapes_sr_demo.yaml", "configs/adm/cifar10_guided.yaml",
          "configs/adm/cifar10_classifier.yaml", "configs/flow/cifar10_dit.yaml",
          "configs/flow/cifar10_dit_moe.yaml", "configs/flow/shapes_dit_demo.yaml",
          "configs/flow/shapes_dit_moe_demo.yaml", "configs/latent/shapes_vae_demo.yaml",
          "configs/latent/shapes_latent_demo.yaml",
          "configs/latent/shapes_latent_flow_dit_demo.yaml", "configs/ddpm/lsun_bedroom.yaml",
          "configs/ddpm/lsun_cat.yaml", "configs/ddpm/lsun_church.yaml",
          "configs/iddpm/imagenet64.yaml"}

TINY_YAML = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 100
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitDDIM
  init_args:
    warmup: 10
    timesteps: 10
    sample_steps: 4
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8, 8],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 16, batch_size: 4}}
"""
# the IDDPM harness at the same TINY widths: FiLM, 4 heads at depths 2 and 3,
# the cosine schedule, the hybrid loss, strided sampling
TINY_IDDPM_YAML = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 100
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitIDDPM
  init_args:
    warmup: 10
    timesteps: 10
    schedule: cosine
    loss_type: hybrid
    sample_steps: 4
    dtype: f32
    model:
      class_path: dmme_tpu.models.iddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [8, 8, 16, 16],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 16, batch_size: 4}}
"""


def _tiny(tmp_path, extra=""):
    cfg = tmp_path / "cfg.yaml"
    text = TINY_YAML.format(root=tmp_path / "run")
    if extra:
        text = text.replace("trainer:\n", "trainer:\n" + extra + "\n", 1)
    cfg.write_text(text)
    return cfg


# -------------------------------------------------------------------- config

def test_every_shipped_config_is_listed():
    assert len(SHIPPED) >= 20 and PORTED <= set(SHIPPED)


@pytest.mark.parametrize("path", SHIPPED)
def test_validate_config_accepts_exactly_the_ported_configs(path):
    config = tcfg.load_config(os.path.join(ROOT, path))
    if path in PORTED:
        assert tcfg.validate_config(config) is config
    else:
        with pytest.raises(tcfg.ConfigError, match=r"not ported .*ROADMAP A\.\d+"):
            tcfg.validate_config(config)


def _strict_cases():
    """The rejections of tests/test_cli.py::TestStrictConfig, as edits of a
    valid config (through the dotted overrides where the JAX test uses them)."""

    def set_(path, value):
        def edit(c, module):
            node = c
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = value
        return edit

    return {
        "typoed_trainer_key": (set_(("trainer", "max_step"), 5), "max_step"),
        "typoed_override": (lambda c, m: m.apply_overrides(c, ["--model.init_args.lrr",
                                                                 "1e-4"]), "lrr"),
        "typoed_init_arg": (set_(("model", "init_args", "leraning_rate"), 1e-4),
                            "leraning_rate"),
        "unknown_top_level": (set_(("modle",), {}), "modle"),
        "bad_mesh_axis": (set_(("trainer", "mesh"), {"data": -1, "fsbp": 2}), "fsbp"),
        "callbacks_mapping": (set_(("trainer", "callbacks"),
                                   {"class_path": "dmme_tpu.callbacks.GenerateImage"}),
                              "must be a LIST"),
        "override_through_scalar": (lambda c, m: m.apply_overrides(
            c, ["--trainer.max_steps.typo", "5"]), "max_steps"),
        "bare_string_callback": (set_(("trainer", "callbacks"),
                                      ["dmme_tpu.callbacks.GenerateImage"]), "class_path"),
        "bare_string_model": (set_(("model",), "dmme_tpu.training.LitDDPM"), "class_path"),
    }


@pytest.mark.parametrize("case", sorted(_strict_cases()))
def test_strict_validation_rejects_what_jax_rejects(tmp_path, case):
    from dmme_tpu import config as jcfg

    edit, match = _strict_cases()[case]
    for module in (tcfg, jcfg):
        config = module.load_config(str(_tiny(tmp_path)))
        # LitDDPM: LitDDIM's **kwargs would take any argument
        config["model"]["class_path"] = "dmme_tpu.training.LitDDPM"
        del config["model"]["init_args"]["sample_steps"]
        module.validate_config(config)  # valid before the edit
        with pytest.raises(module.ConfigError, match=match):
            edit(config, module)
            module.validate_config(config)


def test_override_applies_through_a_null_key(tmp_path):
    config = tcfg.load_config(str(_tiny(tmp_path, "  mesh: null")))
    tcfg.apply_overrides(config, ["--trainer.mesh.data", "2", "trainer.max_steps=7",
                                  "--model.init_args.lr", "2e-4"])
    assert config["trainer"]["mesh"] == {"data": 2} and config["trainer"]["max_steps"] == 7
    assert config["model"]["init_args"]["lr"] == 2e-4


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("path", ["configs/ddpm/cifar10.yaml", "configs/ddim/cifar10.yaml",
                                  "configs/ddpm/shapes_demo.yaml",
                                  "configs/ddpm/shapes256_demo.yaml",
                                  "configs/iddpm/cifar10.yaml", "configs/iddpm/shapes_demo.yaml",
                                  "configs/iddpm/shapes64_demo.yaml"])
def test_instantiated_hyperparameters_equal_jax(path):
    from dmme_tpu import config as jcfg

    config = tcfg.load_config(os.path.join(ROOT, path))
    tlit, tdata = tcfg.instantiate(config["model"]), tcfg.instantiate(config["data"])
    jlit, jdata = jcfg.instantiate(config["model"]), jcfg.instantiate(config["data"])
    for name in ("lr", "warmup", "decay", "grad_clip"):
        assert getattr(tlit, name) == getattr(jlit, name), name
    assert tlit.diffusion_model.timesteps == jlit.diffusion_model.timesteps
    assert type(tlit).__name__ == type(jlit).__name__
    if hasattr(jlit.diffusion_model, "loss_type"):  # IDDPM
        for name in ("loss_type", "gamma"):
            assert getattr(tlit.diffusion_model, name) == getattr(jlit.diffusion_model, name)
        np.testing.assert_allclose(tlit.diffusion_model.schedule.alpha_bar.numpy(),
                                   np.asarray(jlit.diffusion_model.schedule.alpha_bar), atol=1e-6)
        jstrided = jlit.sample_algorithm
        assert (tlit.strided is None) == (jstrided is None)
        if jstrided is not None:
            np.testing.assert_array_equal(tlit.strided.timestep_map.numpy(),
                                          np.asarray(jstrided.timestep_map))
        assert tlit.model.output_conv.weight.shape[0] == 2 * tlit.img_channels
    if hasattr(jlit.diffusion_model, "tau"):
        np.testing.assert_array_equal(tlit.diffusion_model.tau.numpy(),
                                      np.asarray(jlit.diffusion_model.tau))
        assert tlit.diffusion_model.sub_timesteps == jlit.diffusion_model.sub_timesteps
    tm, jm = tlit.model, jlit.model
    for name in ("channels_per_depth", "num_blocks", "attention_depths", "dropout", "remat"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert _dtype_name(tm.dtype) == _dtype_name(jm.dtype)
    assert type(tdata).__name__ == type(jdata).__name__
    assert tdata.batch_size == jdata.batch_size and tdata.img_size == jdata.img_size
    trainer = config["trainer"]
    if "callbacks" in trainer:
        (tcb,), (jcb,) = tcfg.instantiate(trainer["callbacks"]), jcfg.instantiate(
            trainer["callbacks"])
        assert tcb.shape == jcb.shape and tcb.every_n_steps == jcb.every_n_steps


@pytest.mark.parametrize("alias,want", [("bf16", "bfloat16"), ("fp32", "float32"),
                                        ("f32", "float32"), ("fp16", "float16"),
                                        ("bfloat16", "bfloat16")])
def test_dtype_aliases_match_jax(alias, want):
    from dmme_tpu import config as jcfg

    node = {"class_path": "dmme_tpu.models.ddpm.UNet",
            "init_args": {"dtype": alias, "channels_per_depth": [4, 8], "num_groups": 2}}
    tm, jm = tcfg.instantiate(node), jcfg.instantiate(node)
    assert _dtype_name(tm.dtype) == _dtype_name(jm.dtype) == want


@pytest.mark.parametrize("path,item", [("dmme_tpu.data.LSUN", "A.12"),
                                       ("dmme_tpu.data.ImageFolder64", "A.12")])
def test_an_unported_class_names_its_roadmap_item(path, item):
    """LSUN and ImageFolder64 waited for ROADMAP ``item`` and now resolve to
    the port's classes; a class the port lacks still raises naming its queue."""
    from dmme_tpu_torch import data as tdata

    assert tcfg.resolve_class(path) is getattr(tdata, path.rsplit(".", 1)[1])
    assert not any(item in v for v in tcfg._NOT_PORTED.values())
    with pytest.raises(tcfg.ConfigError, match="not ported to dmme_tpu_torch yet "
                                               r"\(ROADMAP queue A\)"):
        tcfg.instantiate({"class_path": path + "Missing", "init_args": {}})


@pytest.mark.parametrize("path,name", [("dmme_tpu.training.LitVAE", "latent.LitVAE"),
                                       ("dmme_tpu.training.LitLatentDDPM",
                                        "latent.LitLatentDDPM"),
                                       ("dmme_tpu.training.LitLatentFlow",
                                        "latent.LitLatentFlow"),
                                       ("dmme_tpu.models.vae.ConvVAE", "vae.ConvVAE")])
def test_latent_classes_resolve_to_the_port(path, name):
    """The classes of ROADMAP A.8, unported until latent diffusion came."""
    cls = tcfg.resolve_class(path)
    assert f"{cls.__module__.rpartition('.')[2]}.{cls.__name__}" == name
    assert cls.__module__.startswith("dmme_tpu_torch.")


def test_class_paths_resolve_without_the_jax_package():
    probe = textwrap.dedent("""
        import sys
        from dmme_tpu_torch import config
        for p in sys.argv[1:]:
            c = config.validate_config(config.load_config(p))
            config.instantiate(c["data"])
            try:
                config.instantiate(c["model"])
            except ValueError as e:  # a latent stage 2 whose codec run is absent
                assert "no stage-1 VAE checkpoint" in str(e), e
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dmme_tpu", "flax")))
    """)
    out = subprocess.run([sys.executable, "-c", probe, *sorted(PORTED)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ----------------------------------------------------------------- commands

def test_fit_validate_sample_predict(tmp_path, capsys):
    cfg = str(_tiny(tmp_path))
    main(["fit", "--config", cfg, "--trainer.tensorboard", "true"], device="cpu")
    run = tmp_path / "run"
    assert (run / "metrics.jsonl").exists() and os.listdir(run / "tb")
    assert sorted(os.listdir(run)) == ["2", "metrics.jsonl", "tb"]
    main(["fit", "--config", cfg, "--trainer.max_steps", "3", "--trainer.resume", "true"],
         device="cpu")
    assert (run / "3").exists()
    steps = [int(line.split('"step": ')[1].split(",")[0])
             for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]

    main(["validate", "--config", cfg, "--trainer.limit_val_batches", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "'val/loss'" in out and "'num_batches': 2" in out

    main(["sample", "--config", cfg, "--trainer.sample_batch", "2"], device="cpu")
    assert os.listdir(run / "samples") == ["step_00000003.png"]

    main(["predict", "--config", cfg, "--trainer.limit_predict_batches", "2",
          "--trainer.predict_batch", "3"], device="cpu")
    a, b = (np.load(run / "predictions" / f"pred_0000{k}.npy") for k in (0, 1))
    assert a.shape == (3, 32, 32, 3) and a.dtype == np.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0 and not np.array_equal(a, b)
    # predict's batch 0 is generate() on the restored state with its generator
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm

    config = tcfg.load_config(cfg)
    lit = tcfg.instantiate(config["model"])
    state = CheckpointManager(str(run)).restore(lit.init_state(0, device="cpu"))
    want = denorm(lit.generate(state, step_generator(7, 0, "cpu"), (3, 32, 32, 3)))
    np.testing.assert_array_equal(a, want.numpy())


def test_print_config_and_help(tmp_path, capsys):
    cfg = str(_tiny(tmp_path))
    main(["fit", "--config", cfg, "--print_config", "--model.init_args.lr", "3e-4"],
         device="cpu")
    assert yaml.safe_load(capsys.readouterr().out)["model"]["init_args"]["lr"] == 3e-4
    assert not (tmp_path / "run").exists()  # printing trains nothing
    main(["fit", "--config", cfg, "--help"], device="cpu")
    out = capsys.readouterr().out
    assert "dmme_tpu.training.LitDDIM" in out and "sample_steps" in out
    assert "synthetic_size" in out and "max_steps" in out
    main(["fit", "--config", "/nonexistent/cfg.yaml", "--help"], device="cpu")
    assert "could not introspect" in capsys.readouterr().out


def test_unported_subcommands_and_options_name_their_roadmap_item(tmp_path, capsys):
    cfg = str(_tiny(tmp_path))
    # test (FID / IS, A.9) is ported: it scores the TINY config and prints JAX's keys
    main(["test", "--config", cfg, "--trainer.limit_test_batches", "1"], device="cpu")
    results = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(results) == {"fid", "inception_score", "inception_score_std", "num_batches",
                            "use_ema", "sampler", "sample_steps", "warning"}
    assert results["num_batches"] == 1 and np.isfinite(results["inception_score"])
    # a continuous-time family's sampler on a DDPM model: JAX's ValueError
    with pytest.raises(ValueError, match="sampler=edm needs an EDM-trained model"):
        main(["sample", "--config", cfg, "--trainer.sampler", "edm"], device="cpu")
    with pytest.raises(ValueError, match="sampler=flow needs a flow-matching-trained model"):
        main(["sample", "--config", cfg, "--trainer.sampler", "flow"], device="cpu")
    # spatial is ported (A.11): one process cannot hold two spatial ranks (JAX's assertion)
    with pytest.raises(AssertionError, match=r"\(1, 1, 1, 1, 2\)"):
        main(["fit", "--config", cfg, "--trainer.mesh.spatial", "2"], device="cpu")


def test_serve_builds_a_sampler_on_the_restored_state(tmp_path, monkeypatch):
    from dmme_tpu_torch import serving

    served = {}
    monkeypatch.setattr(serving, "serve_forever",
                        lambda sampler, host, port: served.update(s=sampler, host=host,
                                                                  port=port))
    cfg = str(_tiny(tmp_path))
    main(["fit", "--config", cfg], device="cpu")
    main(["serve", "--config", cfg, "--trainer.port", "8123"], device="cpu")
    assert served["port"] == 8123 and served["s"].step == 2 and served["s"].img_size == 32
    images = served["s"].sample(2, seed=1)
    assert images.shape == (2, 32, 32, 3)


def test_the_command_line_runs_on_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fit", "--config", str(_tiny(tmp_path))])


# ----------------------------------------------------------------- IDDPM

def _tiny_iddpm(tmp_path):
    cfg = tmp_path / "iddpm.yaml"
    cfg.write_text(TINY_IDDPM_YAML.format(root=tmp_path / "run"))
    return str(cfg)


def test_iddpm_fit_resume_and_sample_through_the_solvers(tmp_path, capsys):
    """The IDDPM harness through the command line: fit, resume, then a grid
    from the model's own strided sampler and one from each solver override,
    named after it and its steps."""
    cfg = _tiny_iddpm(tmp_path)
    main(["fit", "--config", cfg], device="cpu")
    main(["fit", "--config", cfg, "--trainer.max_steps", "3", "--trainer.resume", "true"],
         device="cpu")
    run = tmp_path / "run"
    assert (run / "3").exists()
    losses = [float(line.split('"loss": ')[1].split(",")[0])
              for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 3 and np.isfinite(losses).all()
    main(["sample", "--config", cfg, "--trainer.sample_batch", "2"], device="cpu")
    for name, steps in (("dpm", 5), ("ddim", 4), ("unipc", 3)):
        main(["sample", "--config", cfg, "--trainer.sampler", name, "--trainer.sample_steps",
              str(steps), "--trainer.sample_batch", "2"], device="cpu")
    assert sorted(os.listdir(run / "samples")) == [
        "step_00000003.png", "step_00000003_ddim4.png", "step_00000003_dpm5.png",
        "step_00000003_unipc3.png"]
    from PIL import Image

    grid = np.asarray(Image.open(run / "samples" / "step_00000003_dpm5.png"))
    assert grid.shape[-1] == 3 and grid.std() > 0


def test_iddpm_sample_override_is_the_factory_on_the_restored_state(tmp_path):
    """``sample --trainer.sampler dpm`` draws what ``make_sampler`` gives on
    the restored EMA weights from a generator seeded with the step."""
    from PIL import Image

    from dmme_tpu_torch.diffusion import make_sampler
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm
    from dmme_tpu_torch.utils.vis import make_history

    cfg = _tiny_iddpm(tmp_path)
    main(["fit", "--config", cfg], device="cpu")
    main(["sample", "--config", cfg, "--trainer.sampler", "dpm", "--trainer.sample_batch", "2"],
         device="cpu")
    run = tmp_path / "run"
    got = np.asarray(Image.open(run / "samples" / "step_00000002_dpm20.png"))
    lit = tcfg.instantiate(tcfg.load_config(cfg)["model"])
    state = CheckpointManager(str(run)).restore(lit.init_state(0, device="cpu"))
    algo, adapt = make_sampler(lit.diffusion_model, "dpm")
    assert algo.clip_x0 and algo.sub_timesteps == 20  # cosine: ᾱ_T ≈ 2e-15
    out = algo.generate(adapt(lit.model_fn), state.ema_params, torch.Generator().manual_seed(2),
                        (2, 32, 32, 3))
    want = make_history([denorm(out).numpy()])
    np.testing.assert_array_equal(got, (np.clip(want, 0, 1) * 255).astype(np.uint8))


def test_imagenet64_names_what_it_waits_for():
    """configs/iddpm/imagenet64.yaml validates (the IDDPM UNet at the
    ImageNet-64 widths on ``ImageFolder64``, ported with ROADMAP A.12) and
    its ``{data: -1, fsdp: 1}`` mesh is ported (A.11); a ``spatial`` axis
    of 2 on top of it meets JAX's mesh assertion on one process, before any
    data is read, and leaves no process group behind."""
    path = os.path.join(ROOT, "configs/iddpm/imagenet64.yaml")
    config = tcfg.validate_config(tcfg.load_config(path))
    assert config["data"]["class_path"] == "dmme_tpu.data.ImageFolder64"
    assert config["trainer"]["mesh"] == {"data": -1, "fsdp": 1}
    with pytest.raises(AssertionError, match=r"\(1, 1, 1, 1, 2\)"):
        main(["fit", "--config", path, "--data.init_args.synthetic", "true",
              "--data.init_args.synthetic_size", "8", "--trainer.mesh.spatial", "2"],
             device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("harness", ["LitIDDPM", "LitDDIM"])
def test_num_classes_on_a_kwargs_harness_names_a6(tmp_path, harness):
    """Harnesses that take ``**kwargs`` take the class-conditioning arguments
    of ROADMAP A.6 (ported) at validation, and still reject at validation a
    name that no constructor up their MRO takes, instead of dying later in a
    bare ``TypeError``."""
    config = tcfg.load_config(_tiny_iddpm(tmp_path) if harness == "LitIDDPM"
                              else str(_tiny(tmp_path)))
    assert config["model"]["class_path"].endswith(harness)
    config["model"]["init_args"].update(num_classes=10, cond_dropout=0.2, guidance_scale=3.0)
    tcfg.validate_config(config)
    lit = tcfg.instantiate(config["model"])
    assert (lit.num_classes, lit.cond_dropout, lit.guidance_scale) == (10, 0.2, 3.0)
    config["model"]["init_args"]["num_clases"] = 10
    with pytest.raises(tcfg.ConfigError, match=r"unknown key\(s\) \['num_clases'\]"):
        tcfg.validate_config(config)


# ----------------------------------------------------------- EDM and flow

# the EDM and flow harnesses at the TINY widths, f32; EDM with the
# GenerateImage callback of configs/edm/cifar10.yaml (history frames)
TINY_EDM_YAML = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 100
  default_root_dir: {root}
  callbacks:
    - class_path: dmme_tpu.callbacks.GenerateImage
      init_args: {{imgsize: [3, 32, 32], every_n_steps: 2, num_samples: 2,
                   out_dir: {root}/grids}}
model:
  class_path: dmme_tpu.training.LitEDM
  init_args:
    warmup: 10
    sample_steps: 3
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8, 8],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 16, batch_size: 4}}
"""
TINY_FLOW_YAML = TINY_EDM_YAML.replace("LitEDM", "LitFlow").replace(
    "sample_steps: 3", "sample_steps: 3\n    t_sample: uniform")


def _tiny_family(tmp_path, family):
    cfg = tmp_path / f"{family}.yaml"
    cfg.write_text((TINY_EDM_YAML if family == "edm" else TINY_FLOW_YAML).format(
        root=tmp_path / "run"))
    return str(cfg)


@pytest.mark.parametrize("path", ["configs/edm/cifar10.yaml", "configs/edm/shapes_demo.yaml",
                                  "configs/flow/shapes_demo.yaml"])
def test_edm_flow_hyperparameters_equal_jax(path):
    """The EDM and flow configs build the JAX package's harnesses: the recipe,
    the σ grid (or t grid) and every algorithm hyperparameter, the default
    DDPM UNet with both switches on, in bf16."""
    from dmme_tpu import config as jcfg

    config = tcfg.load_config(os.path.join(ROOT, path))
    tlit, jlit = tcfg.instantiate(config["model"]), jcfg.instantiate(config["model"])
    assert type(tlit).__name__ == type(jlit).__name__
    for name in ("lr", "warmup", "decay", "grad_clip"):
        assert getattr(tlit, name) == getattr(jlit, name), name
    ta, ja = tlit.diffusion_model, jlit.diffusion_model
    assert type(ta).__name__ == type(ja).__name__
    grid = "sigmas" if hasattr(ja, "sigmas") else "ts"
    np.testing.assert_allclose(getattr(ta, grid).numpy(), np.asarray(getattr(ja, grid)), rtol=0,
                               atol=1e-6)
    for f in (f.name for f in dataclasses.fields(ta)):
        if f != grid:
            assert getattr(ta, f) == getattr(ja, f), f
    tm = tlit.model
    assert (tm.channels_per_depth, tm.num_blocks, tm.attention_depths) == ((128, 256, 256, 256),
                                                                          2, (2,))
    assert tm.fused_norm and _dtype_name(tm.dtype) == "bfloat16"
    tdata, jdata = tcfg.instantiate(config["data"]), jcfg.instantiate(config["data"])
    assert type(tdata).__name__ == type(jdata).__name__ and tdata.batch_size == jdata.batch_size


@pytest.mark.parametrize("path", ["configs/flow/cifar10_dit.yaml",
                                  "configs/flow/cifar10_dit_moe.yaml"])
def test_flow_dit_configs_still_name_a7(path):
    """These configs named ROADMAP A.7 while the DiT waited for it (the
    name is from then). Since A.7 they validate and build ``LitFlow`` over
    the port's DiT with the config's widths and MoE settings, as JAX's
    config builds its own."""
    from dmme_tpu import config as jcfg

    config = tcfg.validate_config(tcfg.load_config(os.path.join(ROOT, path)))
    assert config["model"]["class_path"] == "dmme_tpu.training.LitFlow"
    lit, jlit = tcfg.instantiate(config["model"]), jcfg.instantiate(config["model"])
    assert type(lit).__name__ == type(jlit).__name__ == "LitFlow"
    assert type(lit.model).__name__ == type(jlit.model).__name__ == "DiT"
    assert lit.moe_aux_weight == jlit.moe_aux_weight
    blocks = [getattr(lit.model, f"block_{i}") for i in range(lit.model.depth)]
    moe = [i for i, b in enumerate(blocks) if b.moe_mlp is not None]
    assert (lit.model.hidden, lit.model.depth, blocks[0].num_heads, lit.model.patch_size) == (
        jlit.model.hidden, jlit.model.depth, jlit.model.num_heads, jlit.model.patch_size)
    assert moe == ([i for i in range(jlit.model.depth) if i % jlit.model.moe_stride == 1]
                   if jlit.model.num_experts else [])
    assert lit.model.dtype == torch.bfloat16


def _serve_and_post(sampler, bodies):
    """Start ``make_server(sampler)``, POST each body, stop; [(status, bytes)]."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from dmme_tpu_torch.serving import make_server

    server = make_server(sampler, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/sample" % server.server_address[:2]
    out = []
    try:
        for body in bodies:
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    out.append((r.status, r.read()))
            except urllib.error.HTTPError as e:
                out.append((e.code, e.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return out


@pytest.mark.parametrize("family", ["edm", "flow"])
def test_edm_flow_fit_validate_sample_serve(tmp_path, capsys, monkeypatch, family):
    """A TINY LitEDM / LitFlow through the command line: fit (GenerateImage
    draws its history frames), validate, sample with the model's own sampler
    and with its family's override, and serve: POST /sample answers
    ``default`` and the family's name, and 400 for the other family and the
    discrete-schedule samplers."""
    import io

    from dmme_tpu_torch import serving
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm

    cfg = _tiny_family(tmp_path, family)
    run = tmp_path / "run"
    main(["fit", "--config", cfg], device="cpu")
    assert os.listdir(run / "grids") == ["step_00000002.png"]
    losses = [float(line.split('"loss": ')[1].split(",")[0])
              for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    main(["validate", "--config", cfg, "--trainer.limit_val_batches", "1"], device="cpu")
    assert "'val/loss'" in capsys.readouterr().out
    main(["sample", "--config", cfg, "--trainer.sample_batch", "2"], device="cpu")
    main(["sample", "--config", cfg, "--trainer.sampler", family, "--trainer.sample_batch", "2"],
         device="cpu")
    main(["sample", "--config", cfg, "--trainer.sampler", family, "--trainer.sample_steps", "2",
          "--trainer.sample_batch", "2"], device="cpu")
    default_steps = 18 if family == "edm" else 25
    assert sorted(os.listdir(run / "samples")) == sorted([
        "step_00000002.png", f"step_00000002_{family}2.png",
        f"step_00000002_{family}{default_steps}.png"])
    with pytest.raises(ValueError, match="needs a discrete-schedule model"):
        main(["sample", "--config", cfg, "--trainer.sampler", "deep"], device="cpu")

    served = {}
    monkeypatch.setattr(serving, "serve_forever",
                        lambda sampler, host, port: served.update(s=sampler))
    main(["serve", "--config", cfg], device="cpu")
    other = "flow" if family == "edm" else "edm"
    names = ["default", family, other, "ddim", "cached", "deep", "deep_dpm"]
    answers = _serve_and_post(served["s"], [{"n": 2, "seed": 3, "format": "npy", "sampler": n,
                                             "steps": 2} for n in names])
    codes = dict(zip(names, (code for code, _ in answers)))
    assert codes == {n: 200 if n in ("default", family) else 400 for n in names}
    lit = tcfg.instantiate(tcfg.load_config(cfg)["model"])
    state = CheckpointManager(str(run)).restore(lit.init_state(0, device="cpu"))
    want = lit.generate(state, torch.Generator().manual_seed(3), (2, 32, 32, 3), sampler=family,
                        steps=2)
    got = np.load(io.BytesIO(answers[1][1]))
    np.testing.assert_array_equal(got, denorm(want).numpy())


def test_feature_caching_samplers_through_the_command_line(tmp_path, monkeypatch):
    """``sample --trainer.sampler cached|deep|deep_dpm`` and ``serve`` honour
    ``trainer.refresh_interval`` and ``trainer.cache_depth``: the grid and the
    served images are the factory's sampler with those knobs on the
    restored EMA weights."""
    from PIL import Image

    from dmme_tpu_torch import serving
    from dmme_tpu_torch.diffusion.factory import make_module_sampler
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm
    from dmme_tpu_torch.utils.vis import make_history

    cfg = str(_tiny(tmp_path))
    knobs = ["--trainer.refresh_interval", "3", "--trainer.cache_depth", "2"]
    main(["fit", "--config", cfg], device="cpu")
    run = tmp_path / "run"
    for name in ("cached", "deep", "deep_dpm"):
        main(["sample", "--config", cfg, "--trainer.sampler", name, "--trainer.sample_steps", "4",
              "--trainer.sample_batch", "2", *knobs], device="cpu")
    main(["sample", "--config", cfg, "--trainer.sampler", "deep", "--trainer.sample_batch", "2"],
         device="cpu")
    assert sorted(os.listdir(run / "samples")) == [
        "step_00000002_cached4.png", "step_00000002_deep4.png", "step_00000002_deep50.png",
        "step_00000002_deep_dpm4.png"]
    lit = tcfg.instantiate(tcfg.load_config(cfg)["model"])
    state = CheckpointManager(str(run)).restore(lit.init_state(0, device="cpu"))
    algo = make_module_sampler(lit.diffusion_model, "deep", 4, refresh_interval=3, cache_depth=2)
    out = algo.generate(lit.model, state.ema_params, torch.Generator().manual_seed(2),
                        (2, 32, 32, 3))
    want = (np.clip(make_history([denorm(out).numpy()]), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(run / "samples" /
                                                        "step_00000002_deep4.png")), want)

    served = {}
    monkeypatch.setattr(serving, "serve_forever",
                        lambda sampler, host, port: served.update(s=sampler))
    main(["serve", "--config", cfg, *knobs], device="cpu")
    assert (served["s"].refresh_interval, served["s"].cache_depth) == (3, 2)
    got = served["s"].sample(2, sampler="deep", steps=4, seed=2)
    np.testing.assert_array_equal(got, denorm(out).numpy())
