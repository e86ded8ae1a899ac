"""Progressive distillation, round by round (mirrors ``scripts/distill.py``):

    python -m dmme_tpu_torch.distill --config configs/ddpm/cifar10.yaml \\
        --start-steps 500 --rounds 3 --steps-per-round 10000 --out runs/distill

Builds the teacher from the config (model and data) and restores its latest
checkpoint from the config's ``trainer.default_root_dir``; without one it
warns and distils the untrained teacher. Round k trains an N/2^k-step
v-parameterised student against the previous round's model (the EMA
weights) through the standard ``fit`` loop, into
``<out>/round_<k>_steps_<N>/``; the student is the next round's teacher, and
the rounds stop after an odd N. The initial teacher may be ε-parameterised
(the DDPM recipe); the distiller converts.

Runs on the CUDA device; ``main(argv, device="cpu")`` is the tests' way onto
the CPU.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="teacher training config")
    ap.add_argument("--start-steps", type=int, default=None,
                    help="first student's sampler steps (teacher uses 2x); "
                    "default = the model's timesteps // 2")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps-per-round", type=int, default=10_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--decay", type=float, default=0.999,
                    help="student EMA decay; short distillation rounds need a faster-adapting "
                    "EMA than the 0.9999 training default (at 3k steps, 0.9999 leaves the EMA "
                    "~74%% at its random init)")
    ap.add_argument("--out", default="runs/distill")
    ap.add_argument("--teacher-parameterization", default=None,
                    help="override; defaults to the teacher config's setting")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> list:
    """Run the rounds; returns the (student steps, output directory) of each."""
    args = parse_args(argv)

    from dmme_tpu_torch.config import instantiate, load_config, validate_config
    from dmme_tpu_torch.diffusion import ProgressiveDistillation
    from dmme_tpu_torch.training import LitDistill, fit
    from dmme_tpu_torch.training.checkpoint import CheckpointManager
    from dmme_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    config = validate_config(load_config(args.config))
    teacher_lit = instantiate(config["model"])
    data = instantiate(config["data"])
    tc = config.get("trainer") or {}

    state = teacher_lit.init_state(0, device=device)
    ckpt_dir = tc.get("default_root_dir")
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            state = mgr.restore(state)
            print(f"# teacher restored from {ckpt_dir} @ step {int(state.step)}", flush=True)
        else:
            print("# WARNING: no teacher checkpoint found — distilling an untrained teacher "
                  "(smoke-test mode)", file=sys.stderr, flush=True)

    teacher_model = teacher_lit.model
    teacher_params = state.ema_params
    teacher_param_type = args.teacher_parameterization or getattr(
        teacher_lit.diffusion_model, "parameterization", "eps")
    timesteps = teacher_lit.diffusion_model.timesteps
    del state, teacher_lit  # the teacher's EMA weights are all a round needs

    # by default the first round distils the T-step teacher into T/2 steps
    steps = args.start_steps if args.start_steps is not None else timesteps // 2
    rounds = []
    for k in range(args.rounds):
        pd = ProgressiveDistillation.create(timesteps=timesteps, student_steps=steps,
                                            teacher_parameterization=teacher_param_type,
                                            student_parameterization="v")
        lit = LitDistill(teacher_model=teacher_model, teacher_params=teacher_params,
                         distiller=pd, lr=args.lr, decay=args.decay,
                         init_params=teacher_params if teacher_param_type == "v" else None)
        out_dir = f"{args.out}/round_{k}_steps_{steps}"
        print(f"# round {k}: {2 * steps}-step teacher -> {steps}-step student "
              f"({args.steps_per_round} train steps) -> {out_dir}", flush=True)
        st = fit(lit, data, max_steps=args.steps_per_round,
                 seed=int(config.get("seed_everything", 1337)), ckpt_dir=out_dir,
                 ckpt_every=args.steps_per_round, log_every=int(tc.get("log_every_n_steps", 50)),
                 device=device)
        rounds.append((steps, out_dir))
        # the student becomes the next round's (v-parameterised) teacher;
        # the rest of this round's state is dropped
        teacher_model, teacher_params, teacher_param_type = lit.model, st.ema_params, "v"
        del lit, st
        if steps % 2 == 1:
            break
        steps //= 2
    return rounds


if __name__ == "__main__":
    main()
