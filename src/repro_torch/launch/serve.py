"""Serving launcher, static engine: optional RSI compression, then one
batched prefill and greedy decode (``greedy_generate``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --engine static \\
        --compress-alpha 0.3 [--q 4] [--batch 4 --prompt-len 16 --gen 32] \\
        [--reduced] [--seed 0] [--device cuda|cpu]

The port's counterpart of ``repro/launch/serve.py --engine static``; the
continuous engine is not yet ported.  Runs on the card unless ``--device
cpu`` is given.  Prints the dispatcher's per-site counters after
generation, so every linear and attention call shows the path it took.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=["static"], default="static",
                    help="only the static greedy path is ported")
    ap.add_argument("--batch", type=int, default=4, help="number of requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--compress-alpha", type=float, default=0.0)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import analytic_param_count, build_model
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.train.serve_step import greedy_generate

    cfg = get_arch(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    n0 = analytic_param_count(cfg)

    if args.compress_alpha > 0:
        policy = CompressionPolicy(alpha=args.compress_alpha, q=args.q, min_dim=16)
        params, rep = compress_tree(params, policy, generator=torch.Generator(device=dev).manual_seed(1))
        print("[compress]", rep.summary())

    data = SyntheticLM(cfg, batch=args.batch, seq=args.prompt_len, kind="serve", seed=args.seed)
    batch = {"tokens": torch.as_tensor(data.at_step(0)["tokens"], dtype=torch.int64, device=dev)}
    max_len = args.prompt_len + args.gen

    dcfg = DispatchConfig.from_arch(cfg)
    dispatch.reset_counters()
    t0 = time.perf_counter()
    with use_dispatch(dcfg):
        out = greedy_generate(model, params, batch, steps=args.gen, max_len=max_len)
    out = out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"[static] generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, params {n0/1e6:.1f}M, "
          f"kernels={dcfg.backend}, device={dev})")
    print("first sequences:", out[: min(2, args.batch), :12].tolist())
    print("[dispatch] per-site kernel paths:")
    print(dispatch.format_counters())
    return out


if __name__ == "__main__":
    main()
