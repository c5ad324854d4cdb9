"""Continuous-batching serving demo: an RSI-compressed model under live traffic.

    python -m repro_torch.experiments.continuous_serving [--alpha 0.3] [--q 4] [--device cuda|cpu]
    python -m repro_torch.experiments.continuous_serving --paged
    python -m repro_torch.experiments.continuous_serving --sessions

The twin of the reference's ``examples/continuous_serving.py``, on the same
reduced llama3.2-1b with the same seeds and printed lines:
  * requests with DIFFERENT prompt lengths, output budgets and sampling
    params (greedy / temperature / top-k) sharing one slotted KV-cache pool;
  * slot exhaustion queueing and mid-stream admission: more requests than
    slots, so finished sequences hand their slot to waiting ones;
  * the greedy-parity contract, asserted: a greedy request served under
    continuous batching emits exactly the tokens ``greedy_generate``
    produces for that prompt alone;
  * RSI compression (the paper's Alg 3.1) as a serving lever;
  * with ``--paged``: the PAGED KV pool at HALF the flat pool's capacity,
    admission gated on page need, one long prompt prefilled in chunks
    interleaved with the running decodes;
  * with ``--shared``: system-prompt traffic over the paged pool with
    copy-on-write PREFIX SHARING;
  * with ``--sessions``: the SESSION CACHE, a 3-turn conversation whose every
    follow-up prompt extends the previous reply and re-prefills only its
    new user tokens.
Runs on the card unless ``--device cpu`` is given; there the decode block
is a captured CUDA graph.  Sampled streams come from the port's own
sampler, so only the greedy ones equal the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params
from repro_torch.models.model import build_model
from repro_torch.runtime.device import resolve_device
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.train.serve_step import greedy_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--n-slots", type=int, default=3)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve from a paged KV pool at half the flat capacity, with one long prompt "
                         "chunk-prefilled")
    ap.add_argument("--shared", action="store_true",
                    help="system-prompt traffic over the paged pool with copy-on-write prefix sharing "
                         "(implies --paged)")
    ap.add_argument("--sessions", action="store_true",
                    help="after the shared run, drive a 3-turn conversation through the warm session cache: each "
                         "follow-up prompt extends the previous reply and skips its re-prefill (implies --shared)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.sessions:
        args.shared = True
    if args.shared:
        args.paged = True
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = get_arch("llama3.2-1b", reduced=True)
    model = build_model(cfg, device=dev)
    params = model.init(gen(args.seed))
    # simulate pretrained weights (slow-decay spectra): the paper's regime
    params = spectralize_params(params, gen(9))
    if args.alpha > 0:
        params, rep = compress_tree(params, CompressionPolicy(alpha=args.alpha, q=args.q, min_dim=16),
                                    generator=gen(1))
        print(f"[compress] {rep.summary()}")

    rng = np.random.default_rng(args.seed)
    max_len = 64 if args.shared else 48  # room for the 16-token system prompt
    # --shared: every request opens with the same 16-token system prompt (two
    # full 8-token pages) followed by its own suffix
    sys_prompt = rng.integers(0, cfg.vocab, size=(16,)) if args.shared else None
    reqs = []
    for i in range(args.n_requests):
        # a mixed workload: even requests greedy, odd ones sampled
        sp = SamplingParams() if i % 2 == 0 else SamplingParams(temperature=0.8, top_k=40, seed=100 + i)
        prompt = rng.integers(0, cfg.vocab, size=(int(rng.integers(4, 17)),))
        if sys_prompt is not None:
            prompt = np.concatenate([sys_prompt, prompt])
        reqs.append(Request(prompt=prompt, max_new_tokens=int(rng.integers(6, 20)), sampling=sp))

    paged_kw = {}
    if args.paged:
        # half the flat pool's token capacity, 8-token pages, and prompts
        # longer than 12 tokens prefilled in chunks between decode blocks
        paged_kw = dict(page_size=8, kv_pages=args.n_slots * max_len // (2 * 8), prefill_chunk=12,
                        share_prefix=args.shared)
        reqs.append(Request(prompt=rng.integers(0, cfg.vocab, size=(30,)), max_new_tokens=8))  # chunk-prefills
    eng = Engine(model, params, n_slots=args.n_slots, max_len=max_len, **paged_kw)
    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in done)
    print(f"[engine] {len(done)} requests ({args.n_slots} slots), {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s, {eng.steps} shared decode steps)")
    if args.paged:
        print(f"[paged] {eng.kv_pages} pages of {eng.page_size} tokens — "
              f"half the flat pool's {args.n_slots}x{max_len}-token reservation "
              f"({eng.kv_bytes_capacity} B pool, peak {eng.peak_pages_in_use} "
              f"pages / {eng.kv_bytes_peak} B resident, "
              f"{eng.prefill_chunks} prefill chunks interleaved)")
    if args.shared:
        print(f"[shared] {eng.shared_page_hits} prefix pages mapped read-only "
              f"across {eng.shared_admissions} admissions "
              f"({eng.cow_forks} copy-on-write forks) — the system prompt's "
              f"pages were prefilled once and counted once")
    for r in sorted(done, key=lambda r: r.uid):
        kind = "greedy" if r.sampling.temperature == 0 else f"T={r.sampling.temperature} k={r.sampling.top_k}"
        print(f"  req {r.uid}: prompt {r.prompt.size:2d} -> {len(r.tokens):2d} tokens "
              f"[{kind:12s}] latency {r.latency*1e3:6.0f}ms  {r.tokens[:8]}")

    # greedy-parity spot check against the plain decode loop
    g = next(r for r in done if r.sampling.temperature == 0)
    ref = greedy_generate(model, params, {"tokens": torch.as_tensor(g.prompt[None], device=dev)},
                          steps=g.max_new_tokens, max_len=max_len)[0].tolist()
    assert g.tokens == ref, (g.tokens, ref)
    print(f"[parity] request {g.uid} matches greedy_generate exactly: OK")
    out = {"done": done, "engine": eng, "parity_uid": g.uid, "turns": []}

    if args.sessions:
        # a 3-turn conversation on the WARM engine: turn t+1's prompt is turn
        # t's prompt + reply + new user tokens, so it matches the pages turn
        # t's decode filled and prefills only the new suffix
        print("[sessions] 3-turn conversation through the warm session cache:")
        ctx = np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, size=(5,))])
        for turn in range(3):
            r = eng.run([Request(prompt=ctx.copy(), max_new_tokens=8)])[0]
            print(f"  turn {turn}: prompt {ctx.size:2d} tokens, re-prefilled "
                  f"{ctx.size - r.prefill_skipped:2d} (skipped "
                  f"{r.prefill_skipped:2d} via matched pages), "
                  f"ttft {r.ttft*1e3:4.0f}ms -> reply {r.tokens}")
            out["turns"].append(r)
            ctx = np.concatenate([ctx, np.asarray(r.tokens, np.int64), rng.integers(0, cfg.vocab, size=(4,))])
    return out


if __name__ == "__main__":
    main()
