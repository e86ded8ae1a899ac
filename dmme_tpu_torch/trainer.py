"""The command line: ``python -m dmme_tpu_torch.trainer {fit,validate,test,sample,predict,serve}
--config cfg.yaml [--dotted.overrides value ...]`` (mirrors ``dmme_tpu/trainer.py``).

The config schema is the JAX package's, and the repo's YAML runs unedited
(``dmme_tpu.…`` class paths resolve to the port's classes, see
:mod:`dmme_tpu_torch.config`):

.. code-block:: yaml

    seed_everything: 1337
    trainer:
      max_steps: 800000
      log_every_n_steps: 50
      ckpt_every_n_steps: 100000
      default_root_dir: runs/ddpm_cifar10   # checkpoints, metrics.jsonl, tb/, samples/
      callbacks: [{class_path: dmme_tpu.callbacks.GenerateImage, init_args: {...}}]
    model: {class_path: dmme_tpu.training.LitDDPM, init_args: {...}}
    data:  {class_path: dmme_tpu.data.CIFAR10, init_args: {...}}

The command line always runs on the CUDA device. ``main(argv, device="cpu")``
is the tests' way onto the CPU; ``device`` is not a config key.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

import numpy as np
import torch

from dmme_tpu_torch.config import (TRAINER_KEYS, apply_overrides, describe_class, instantiate,
                                   load_config, validate_config)
from dmme_tpu_torch.diffusion.factory import check_sampler, default_steps
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.utils.device import resolve_device


def _build(config: Dict[str, Any]):
    model = instantiate(config.get("model"))
    data = instantiate(config.get("data"))
    trainer_cfg = dict(config.get("trainer") or {})
    callbacks = instantiate(trainer_cfg.pop("callbacks", []) or [])
    return model, data, trainer_cfg, callbacks


def _require_diffusion_harness(model, command: str) -> None:
    """Raise for a harness that has no diffusion loss or sampler (the noisy
    classifier): JAX's ``validate``, ``test``, ``sample``, ``predict`` and
    ``serve`` fail on one too, deeper in."""
    if not hasattr(model, "generate"):
        raise ValueError(
            f"{command} needs a diffusion harness; {type(model).__name__} trains a noisy "
            "classifier and has nothing to sample or validate (sample its generator with "
            "classifier guidance: dmme_tpu_torch.diffusion.ClassifierGuidedDDIM)")


def cmd_fit(config: Dict[str, Any], device) -> None:
    from dmme_tpu_torch.training import fit

    model, data, tc, callbacks = _build(config)
    fit(
        model,
        data,
        max_steps=int(tc.get("max_steps", 800_000)),
        seed=int(config.get("seed_everything", 1337)),
        mesh=tc.get("mesh") or None,
        log_every=int(tc.get("log_every_n_steps", 50)),
        ckpt_dir=tc.get("default_root_dir"),
        ckpt_every=int(tc.get("ckpt_every_n_steps", 100_000)),
        ckpt_max_to_keep=tc.get("ckpt_max_to_keep", 3),  # None keeps every checkpoint
        callbacks=callbacks,
        resume=config.get("ckpt_path") is not None or bool(tc.get("resume", False)),
        max_restarts=int(tc.get("max_restarts") or 0),
        accumulate_grad_batches=int(tc.get("accumulate_grad_batches") or 1),
        steps_per_call=int(tc.get("steps_per_call") or 1),
        debug_nans=bool(tc.get("detect_anomaly", False)),
        tensorboard=bool(tc.get("tensorboard", False)),  # event files under <root>/tb
        loggers=instantiate(tc.get("loggers")) if tc.get("loggers") else None,
        device=device,
    )


def cmd_test(config: Dict[str, Any], device) -> None:
    """FID and Inception Score over generated samples (``training.evaluate.test``)."""
    from dmme_tpu_torch.training.evaluate import test

    model, data, tc, _ = _build(config)
    _require_diffusion_harness(model, "test")
    results = test(
        model, data,
        ckpt_dir=tc.get("default_root_dir"),
        ckpt_step=tc.get("ckpt_step"),
        seed=int(config.get("seed_everything", 1337)),
        max_batches=tc.get("limit_test_batches"),
        # FID-standard InceptionV3 weights: pytorch-fid's .pth or the JAX package's .npz
        inception_weights=tc.get("inception_weights"),
        mesh=tc.get("mesh") or None,
        fid_stats=tc.get("fid_stats"),            # precomputed real (μ, Σ) .npz
        save_fid_stats=tc.get("save_fid_stats"),  # persist this run's real statistics
        use_ema=None if tc.get("use_ema") is None else bool(tc.get("use_ema")),
        sampler=tc.get("sampler"),                # e.g. dpm: FID at 20 network evaluations
        sample_steps=tc.get("sample_steps"),
        device=device,
    )
    print(results)


def cmd_validate(config: Dict[str, Any], device) -> None:
    """The mean eval-mode diffusion loss over the test split, no generation."""
    from dmme_tpu_torch.training.evaluate import validate

    model, data, tc, _ = _build(config)
    _require_diffusion_harness(model, "validate")
    results = validate(
        model, data,
        ckpt_dir=tc.get("default_root_dir"),
        ckpt_step=tc.get("ckpt_step"),
        seed=int(config.get("seed_everything", 1337)),
        max_batches=tc.get("limit_val_batches"),
        use_ema=None if tc.get("use_ema") is None else bool(tc.get("use_ema")),
        device=device,
    )
    print(results)


def _restore_state(model, data, tc: Dict[str, Any], device):
    """(state, img_size, ckpt_dir): a fresh state with the latest (or
    ``trainer.ckpt_step``'s) checkpoint restored into it. The image size
    comes from ``trainer.img_size``, else the data module's class, else its
    data. Shared by sample, predict and serve."""
    from dmme_tpu_torch.training.checkpoint import CheckpointManager

    img_size = tc.get("img_size") or getattr(data, "img_size", None)
    if img_size is None:
        data.prepare_data()
        data.setup("fit")
        img_size = data.train_data.shape[1]
    state = model.init_state(0, device=device)
    ckpt_dir = tc.get("default_root_dir")
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        step = tc.get("ckpt_step")
        if step is not None or mgr.latest_step() is not None:
            state = mgr.restore(state, step=step)
    return state, int(img_size), ckpt_dir


def cmd_sample(config: Dict[str, Any], device) -> None:
    """One sample grid from the restored checkpoint, written under
    ``<default_root_dir>/samples``: a trajectory a row with the model's own
    sampler, or, with ``trainer.sampler`` and ``trainer.sample_steps``, the
    final images of that sampler, drawn from a generator seeded with the
    checkpoint's step: ddim | dpm | unipc on the trained schedule, edm | flow
    on an EDM or flow model's trained hyperparameters
    (:func:`dmme_tpu_torch.diffusion.factory.make_sampler`), cached | deep |
    deep_dpm with the feature-caching samplers, configured by
    ``trainer.refresh_interval`` and ``trainer.cache_depth``
    (:func:`dmme_tpu_torch.diffusion.factory.make_module_sampler`). A
    class-conditional model samples through classifier-free guidance on
    uniform labels."""
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.training.evaluate import (_reject_conditioned_input,
                                                  reject_sampler_override)

    model, data, tc, _ = _build(config)
    _require_diffusion_harness(model, "sample")
    sampler = tc.get("sampler")
    if sampler:
        check_sampler(sampler)
        _reject_conditioned_input(model, "sample --trainer.sampler")
        reject_sampler_override(model)
    state, img_size, ckpt_dir = _restore_state(model, data, tc, device)
    n = int(tc.get("sample_batch") or 8)
    out_dir = os.path.join(ckpt_dir or ".", "samples")
    step = int(state.step)
    if not sampler:
        cb = GenerateImage(imgsize=(model.img_channels, img_size, img_size), num_samples=n,
                           out_dir=out_dir)
        print(cb.generate_and_save(step, model, state))
        return
    from dmme_tpu_torch.training.loggers import _to_png
    from dmme_tpu_torch.utils.norm import denorm
    from dmme_tpu_torch.utils.vis import make_history

    steps = int(tc.get("sample_steps") or default_steps(sampler))
    # an IMAGE shape: a latent harness's generate maps it and decodes
    out = model.generate(state, torch.Generator(device=device).manual_seed(step),
                         (n, img_size, img_size, model.img_channels), sampler=sampler,
                         steps=steps, **_cache_options(tc))
    grid = make_history([denorm(out).to(torch.float32).cpu().numpy()])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step_{step:08d}_{sampler}{steps}.png")
    with open(path, "wb") as f:
        f.write(_to_png(grid)[0])
    print(path)


def _cache_options(tc: Dict[str, Any]) -> Dict[str, int]:
    """The feature-caching samplers' ``trainer.refresh_interval`` (default 2)
    and ``trainer.cache_depth`` (default 1)."""
    return {"refresh_interval": int(tc.get("refresh_interval") or 2),
            "cache_depth": int(tc.get("cache_depth") or 1)}


def cmd_predict(config: Dict[str, Any], device) -> None:
    """``trainer.limit_predict_batches`` batches (default 1) of raw samples,
    each as ``<default_root_dir>/predictions/pred_<k>.npy``, float32 NHWC in
    [0, 1]. Batch k draws from the generator of (seed, k), as
    ``fold_in(PRNGKey(seed), k)`` keys JAX's."""
    from dmme_tpu_torch.utils.norm import denorm

    model, data, tc, _ = _build(config)
    _require_diffusion_harness(model, "predict")
    state, img_size, ckpt_dir = _restore_state(model, data, tc, device)
    batch = int(tc.get("predict_batch") or getattr(data, "batch_size", None) or 16)
    n_batches = int(tc.get("limit_predict_batches") or 1)
    out_dir = os.path.join(ckpt_dir or ".", "predictions")
    os.makedirs(out_dir, exist_ok=True)
    seed = int(config.get("seed_everything", 1337))
    shape = (batch, img_size, img_size, model.img_channels)
    for k in range(n_batches):
        out = model.generate(state, step_generator(seed, k, device), shape)
        np.save(os.path.join(out_dir, f"pred_{k:05d}.npy"),
                denorm(out).to(torch.float32).cpu().numpy())
    print(out_dir)


def cmd_serve(config: Dict[str, Any], device) -> None:
    """Serve the restored checkpoint over HTTP (:mod:`dmme_tpu_torch.serving`):
    GET /healthz, POST /sample {n, sampler, steps, seed, format}."""
    from dmme_tpu_torch import serving

    model, data, tc, _ = _build(config)
    _require_diffusion_harness(model, "serve")
    state, img_size, _ = _restore_state(model, data, tc, device)
    serving.serve_forever(serving.Sampler(model, state, img_size, device=device,
                                          **_cache_options(tc)),
                          host=str(tc.get("host", "127.0.0.1")), port=int(tc.get("port", 8000)))


def _introspective_help(config: Dict[str, Any]) -> str:
    """``--help`` with a config: every constructor argument of its classes."""
    sections = ["trainer: (known keys)\n  " + "\n  ".join(sorted(TRAINER_KEYS))]
    for slot in ("model", "data"):
        node = config.get(slot)
        if isinstance(node, dict) and "class_path" in node:
            sections.append(f"{slot} → " + describe_class(node["class_path"]))
    sections.append("Override any key with --<dotted.path> <value> "
                    "(e.g. --model.init_args.lr 1e-4); unknown keys are rejected.")
    return "\n\n".join(sections)


COMMANDS = {
    "fit": cmd_fit,
    "validate": cmd_validate,  # mean eval loss, no generation
    "test": cmd_test,          # FID / IS over generated samples
    "sample": cmd_sample,      # a PNG grid
    "predict": cmd_predict,    # per-batch .npy samples
    "serve": cmd_serve,        # the HTTP sampling server
}


def main(argv=None, *, device=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the subcommand on
    ``device`` (None: the CUDA device, raising without one)."""
    parser = argparse.ArgumentParser(
        prog="dmme_tpu_torch.trainer",
        epilog="With --config, --help lists the target classes' constructor args; "
               "--print_config dumps the resolved (validated) YAML.")
    parser.add_argument("subcommand", choices=list(COMMANDS))
    parser.add_argument("--config", required=True)
    parser.add_argument("--print_config", action="store_true",
                        help="print the resolved config (after overrides) as YAML and exit")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        cfg_path = None
        for i, a in enumerate(argv):
            if a == "--config" and i + 1 < len(argv):
                cfg_path = argv[i + 1]
            elif a.startswith("--config="):
                cfg_path = a.split("=", 1)[1]
        if cfg_path:
            parser.print_help()
            print()
            try:  # a missing file or an unported class must not turn --help into a traceback
                print(_introspective_help(load_config(cfg_path)))
            except Exception as e:  # noqa: BLE001
                print(f"(could not introspect {cfg_path!r}: {e})")
            return
    args, overrides = parser.parse_known_args(argv)
    config = validate_config(apply_overrides(load_config(args.config), overrides))
    if args.print_config:
        import yaml

        print(yaml.safe_dump(config, sort_keys=False), end="")
        return
    COMMANDS[args.subcommand](config, resolve_device(device))


def script_main() -> None:
    """The console script and ``python -m dmme_tpu_torch.trainer``."""
    main()


if __name__ == "__main__":
    script_main()
