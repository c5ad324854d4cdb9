"""Training launcher: the checkpoint-restart loop with a straggler watchdog.

    python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
        --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cuda|cpu]

The port's counterpart of ``repro/launch/train.py``, with its flags.
``--fake-devices N`` is accepted as the reference's is: the reference sets
its host's device count with it and builds no mesh, so its loop runs on
one device; so does this one, and it says so.  The fake world of many
ranks is the dry-run's (``launch/dryrun.py``).  Runs on the card
unless ``--device cpu`` is given.  The optimizer is the arch's
``cfg.optimizer`` (AdamW at weight decay 0.01, Adafactor or SGD-momentum)
under a cosine schedule with ``steps // 20`` warmup steps.
``--compress-alpha`` RSI-compresses the params first (``min_dim`` 32), so
the run fine-tunes the factors.  The restart contract: rerunning the same
command resumes from the latest valid checkpoint in ``--ckpt-dir`` with
identical results (the data is a pure function of the step).  The step runs
under the arch's kernel policy (``DispatchConfig.from_arch``).
``main(argv)`` returns ``(state, metrics)``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fake-devices", type=int, default=0)
    ap.add_argument("--compress-alpha", type=float, default=0.0,
                    help="if >0: RSI-compress params before training (low-rank fine-tune)")
    ap.add_argument("--compress-q", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.fake_devices < 0:
        ap.error(f"--fake-devices takes a positive count of devices, not {args.fake_devices}")
    if args.fake_devices:
        print(f"[fake-devices] {args.fake_devices} devices requested: no mesh is built from them, the training "
              "loop runs on one device (the dry-run, launch/dryrun.py, steps one rank of a fake world)")

    import torch

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainState, init_train_state, make_train_step

    cfg = get_arch(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    dev = model.device
    opt = {
        "adamw": lambda s: opt_mod.adamw(s, weight_decay=0.01),
        "adafactor": opt_mod.adafactor,
        "sgdm": opt_mod.sgdm,
    }[cfg.optimizer](opt_mod.cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps))

    state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(args.seed))
    if args.compress_alpha > 0:
        policy = CompressionPolicy(alpha=args.compress_alpha, q=args.compress_q, min_dim=32)
        with torch.no_grad():
            new_params, rep = compress_tree(state.params, policy, generator=torch.Generator(device=dev).manual_seed(1))
        print("[compress]", rep.summary())
        state = TrainState(params=new_params, opt_state=opt.init(new_params), step=state.step)

    start_step = 0
    checkpointer = None
    if args.ckpt_dir:
        checkpointer = ckpt.Checkpointer(args.ckpt_dir, keep=3)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = ckpt.restore(state, args.ckpt_dir)
            start_step = last
            print(f"[resume] restored step {last} from {args.ckpt_dir}")

    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=args.seed)
    step_fn = make_train_step(model, opt)
    t_start = time.time()

    def on_metrics(step, m):
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  aux {float(m['aux_loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  ({time.time() - t_start:.1f}s)")
            sys.stdout.flush()

    runner = TrainLoopRunner(step_fn, data.at_step, checkpointer, save_every=args.save_every)
    with use_dispatch(DispatchConfig.from_arch(cfg)):
        state, metrics = runner.run(
            state,
            args.steps,
            shard_fn=lambda b: {k: torch.as_tensor(v, device=dev) for k, v in b.items()},
            start_step=start_step,
            on_metrics=on_metrics,
        )
    if checkpointer:
        checkpointer.wait()
    if runner.watchdog.straggler_steps:
        print(f"[watchdog] straggler steps: {runner.watchdog.straggler_steps}")
    if metrics is None:
        print(f"done: nothing to run (checkpoint at step {start_step} >= --steps {args.steps})")
    else:
        print(f"done: final loss {float(metrics['loss']):.4f}")
    return state, metrics


if __name__ == "__main__":
    main()
