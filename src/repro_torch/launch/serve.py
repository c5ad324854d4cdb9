"""Serving launcher: optional RSI compression, then the continuous-batching
engine (default) or one static batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--reduced] \\
        [--engine continuous|static] [--compress-alpha 0.3 --q 4] \\
        [--batch 4 --prompt-len 16 --gen 32] [--seed 0] [--device cuda|cpu] \\
        [--n-slots N --decode-block 8 --page-size P --kv-pages K \\
         --prefill-chunk C --temperature T --top-k K]

The port's counterpart of ``repro/launch/serve.py``.  Runs on the card
unless ``--device cpu`` is given.  ``--engine continuous`` serves ``--batch``
requests through ``repro_torch.serving.Engine`` (on the card its decode
block is a captured CUDA graph) and prints the engine's counters;
``--engine static`` runs ``greedy_generate``.  Both print the dispatcher's
per-site counters at the end, so every linear, attention and SSD scan call
shows the path it took.  ``--prefill-chunk`` is inert for the ssm and
hybrid families (``--arch mamba2-130m``, ``zamba2-1.2b``), which prefill
monolithically, as in the reference.  The reference's prefix-sharing,
overload, cluster and event flags are not ported yet.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=["continuous", "static"], default="continuous")
    ap.add_argument("--batch", type=int, default=4, help="number of requests")
    ap.add_argument("--n-slots", type=int, default=0, help="cache slots in the pool (default: --batch)")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="decode tokens per host round-trip (continuous engine)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV-cache page size in tokens; 0 = flat slot pool (continuous engine)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="pages in the paged pool; 0 = flat-equivalent capacity "
                         "(n_slots * ceil(max_len / page_size))")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts longer than this in page-backed chunks interleaved with "
                         "decode; 0 = monolithic (requires --page-size)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling (continuous engine)")
    ap.add_argument("--top-k", type=int, default=0, help="0 = full vocab (continuous engine)")
    ap.add_argument("--compress-alpha", type=float, default=0.0)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
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
    prompts = np.asarray(data.at_step(0)["tokens"])
    max_len = args.prompt_len + args.gen
    dcfg = DispatchConfig.from_arch(cfg)
    dispatch.reset_counters()

    if args.engine == "static":
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev)}
        t0 = time.perf_counter()
        with use_dispatch(dcfg):
            out = greedy_generate(model, params, batch, steps=args.gen, max_len=max_len)
        out = out.cpu()  # waits for the device
        dt = time.perf_counter() - t0
        print(f"[static] generated {tuple(out.shape)} tokens in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s, params {n0/1e6:.1f}M, "
              f"kernels={dcfg.backend}, device={dev})")
        print("first sequences:", out[: min(2, args.batch), :12].tolist())
    else:
        from repro_torch.serving import Engine, Request, SamplingParams, percentile

        n_slots = args.n_slots or args.batch
        eng = Engine(model, params, n_slots=n_slots, max_len=max_len, dispatch=dcfg,
                     decode_block=args.decode_block, page_size=args.page_size or None,
                     kv_pages=args.kv_pages or None, prefill_chunk=args.prefill_chunk or None)
        # one seed per request, so sampled continuations are not correlated across the batch
        reqs = [Request(prompt=prompts[b], max_new_tokens=args.gen,
                        sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                                seed=args.seed + b))
                for b in range(args.batch)]
        t0 = time.perf_counter()
        done = eng.run(reqs)
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in done)
        errored = [r for r in done if r.status == "error"]
        print(f"[continuous] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s, slots={n_slots}, params {n0/1e6:.1f}M, "
              f"kernels={dcfg.backend}, device={dev}, cuda_graph={eng.cuda_graph})")
        lats = sorted(r.latency for r in done if r.status == "ok")
        lat_s = (f"p50={percentile(lats, 0.5) * 1e3:.0f}ms p95={percentile(lats, 0.95) * 1e3:.0f}ms"
                 if lats else "p50=n/a p95=n/a (0 completed)")
        print(f"latency {lat_s} decode_steps={eng.steps} host_syncs={eng.host_syncs} "
              f"graph_replays={eng.graph_replays} tok_per_sync={eng.tokens_per_sync:.1f} "
              f"util={eng.batch_utilization:.3f} decode_s={eng.decode_seconds:.3f} "
              f"errored={len(errored)}")
        if eng.paged:
            print(f"[paged] page_size={eng.page_size} pool={eng.kv_pages} pages "
                  f"peak_pages={eng.peak_pages_in_use} peak_active={eng.peak_active} "
                  f"prefill_chunks={eng.prefill_chunks} kv_bytes_cap={eng.kv_bytes_capacity} "
                  f"kv_bytes_peak={eng.kv_bytes_peak}")
        if done and done[0].tokens:
            print("first sequence:", done[0].tokens[:12])
        out = done

    print("[dispatch] per-site kernel paths:")
    print(dispatch.format_counters())
    return out


if __name__ == "__main__":
    main()
