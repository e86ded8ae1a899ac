"""The port's config system and command line against the JAX package's.

The repo's YAML names the JAX package's classes; the port resolves them to
its own, accepts exactly the shipped configs whose classes it has, builds
them with the JAX package's hyperparameters, and rejects what the JAX
package's strict validation rejects. The subcommands run a TINY config on
the CPU through ``main(argv, device="cpu")``.
"""

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
          "configs/ddpm/shapes256_demo.yaml"}

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
                                  "configs/ddpm/shapes256_demo.yaml"])
def test_instantiated_hyperparameters_equal_jax(path):
    from dmme_tpu import config as jcfg

    config = tcfg.load_config(os.path.join(ROOT, path))
    tlit, tdata = tcfg.instantiate(config["model"]), tcfg.instantiate(config["data"])
    jlit, jdata = jcfg.instantiate(config["model"]), jcfg.instantiate(config["data"])
    for name in ("lr", "warmup", "decay", "grad_clip"):
        assert getattr(tlit, name) == getattr(jlit, name), name
    assert tlit.diffusion_model.timesteps == jlit.diffusion_model.timesteps
    assert type(tlit).__name__ == type(jlit).__name__
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


@pytest.mark.parametrize("path,item", [("dmme_tpu.training.LitEDM", "A.6"),
                                       ("dmme_tpu.models.iddpm.UNet", "A.4"),
                                       ("dmme_tpu.data.LSUN", "A.12"),
                                       ("dmme_tpu.models.dit.DiT", "A.7")])
def test_an_unported_class_names_its_roadmap_item(path, item):
    with pytest.raises(tcfg.ConfigError, match=f"ROADMAP {item}"):
        tcfg.instantiate({"class_path": path, "init_args": {}})


def test_class_paths_resolve_without_the_jax_package():
    probe = textwrap.dedent("""
        import sys
        from dmme_tpu_torch import config
        for p in sys.argv[1:]:
            c = config.validate_config(config.load_config(p))
            config.instantiate(c["model"]); config.instantiate(c["data"])
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


def test_unported_subcommands_and_options_name_their_roadmap_item(tmp_path):
    cfg = str(_tiny(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        main(["test", "--config", cfg], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        main(["sample", "--config", cfg, "--trainer.sampler", "dpm"], device="cpu")
    with pytest.raises(NotImplementedError, match="A.16"):
        main(["fit", "--config", cfg, "--trainer.mesh.data", "-1"], device="cpu")


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
