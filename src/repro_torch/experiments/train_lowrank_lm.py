"""Low-rank training: train an LM whose linears are RSI-factored from step 0.

    python -m repro_torch.experiments.train_lowrank_lm [--steps 120] [--full] [--alpha 0.5] \\
        [--ckpt-dir DIR] [--device cuda|cpu]

The twin of the reference's ``examples/train_lowrank_lm.py``: mamba2-130m
(reduced, or the real config under ``--full``) compressed at ``--alpha``
with q = 4 and trained through the launcher (``launch/train.py``: batch 8
x 64, a checkpoint every 50 steps), which shows that the factored ``{a, b}``
leaves ``compress_tree`` emits are trainable: their gradients flow through
the low-rank kernel's backward, and on the card every Mamba2 layer's scan
runs the ``ssd_scan`` kernel forward.  Its assertion: the final loss is
under 7.0.  The checkpoints go to ``--ckpt-dir`` (rerunning with the same
directory resumes), else to a temporary directory removed at the end.  Runs
on the card unless ``--device cpu`` is given; ``main(argv)`` returns the
launcher's ``(state, metrics)``.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="rsi_lowrank_train_"))
        launch = ["--arch", "mamba2-130m", "--steps", str(args.steps), "--batch", "8", "--seq", "64",
                  "--ckpt-dir", ckpt_dir, "--save-every", "50", "--compress-alpha", str(args.alpha),
                  "--compress-q", "4"]
        if not args.full:
            launch.append("--reduced")
        if args.device:
            launch += ["--device", args.device]
        state, metrics = train_cli.main(launch)
    if metrics is None or not float(metrics["loss"]) < 7.0:
        raise AssertionError("training diverged")
    print("low-rank training OK")
    return state, metrics


if __name__ == "__main__":
    main()
