"""End-to-end serving example: compress a pretrained-style model with RSI and
serve batched requests through prefill + greedy decode.

    python -m repro_torch.experiments.compress_and_serve [--alpha 0.3] [--q 4] [--device cuda|cpu]

The twin of the reference's ``examples/compress_and_serve.py``, on the same
reduced llama3.2-1b with the same seeds and printed lines:
  * dense vs compressed parameter counts and per-token agreement;
  * q=1 (RSVD) vs q=4 (RSI) divergence from the dense model's generations
    (the serving-level analogue of Table 4.1);
  * batched-request throughput through the model the launcher serves.
Runs on the card unless ``--device cpu`` is given; on the card the
compression's power iterations run the sketch GEMM kernel and the
compressed linears the low-rank kernel.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.runtime.device import resolve_device
from repro_torch.train.serve_step import greedy_generate


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = get_arch("llama3.2-1b", reduced=True)
    model = build_model(cfg, device=dev)
    params = model.init(gen(0))
    # simulate pretrained weights (slow-decay spectra): the paper's regime
    params = spectralize_params(params, gen(9))
    n_dense = _n_params(params)

    data = SyntheticLM(cfg, batch=args.batch, seq=args.prompt_len, kind="serve")
    batch = {"tokens": torch.as_tensor(data.at_step(0)["tokens"], dtype=torch.int64, device=dev)}
    max_len = args.prompt_len + args.gen

    t0 = time.time()
    ref = greedy_generate(model, params, batch, steps=args.gen, max_len=max_len).cpu()
    t_dense = time.time() - t0

    print(f"dense: {n_dense/1e6:.2f}M params, {args.batch*args.gen/t_dense:.1f} tok/s")
    out = {"dense_tokens": ref, "runs": {}}
    for q in (1, args.q):
        policy = CompressionPolicy(alpha=args.alpha, q=q, min_dim=32)
        cp, rep = compress_tree(params, policy, generator=gen(1))
        t0 = time.time()
        toks = greedy_generate(model, cp, batch, steps=args.gen, max_len=max_len).cpu()
        dt = time.time() - t0
        agree = float((toks == ref).float().mean())
        print(f"alpha={args.alpha} q={q}: ratio={rep.ratio:.3f}, "
              f"{args.batch*args.gen/dt:.1f} tok/s, token agreement vs dense = {agree:.1%}")
        out["runs"][q] = {"ratio": rep.ratio, "agreement": agree, "tokens": toks}
    return out


if __name__ == "__main__":
    main()
