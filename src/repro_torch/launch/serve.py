"""Serving launcher: optional RSI compression, then the continuous-batching
engine (default) or one static batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--reduced] \\
        [--engine continuous|static] [--compress-alpha 0.3 --q 4] \\
        [--batch 4 --prompt-len 16 --gen 32 --max-len L] [--seed 0] [--device cuda|cpu] \\
        [--n-slots N --decode-block 8 --page-size P --kv-pages K \\
         --prefill-chunk C --temperature T --top-k K] \\
        [--share-prefix [--warm-cache-pages N] [--close-sessions]] \\
        [--tiers 1.0,0.5 --tier-q 2 --deadline-ms MS --degrade-queue-depth N \\
         --degrade-free-frac F --preempt] \\
        [--replicas N --heartbeat-ms MS --max-failovers K] [--event-log PATH]

The port's counterpart of ``repro/launch/serve.py``.  Runs on the card
unless ``--device cpu`` is given.  ``--engine continuous`` serves ``--batch``
requests through ``repro_torch.serving.Engine`` (on the card its decode
block is a captured CUDA graph) and prints the engine's counters;
``--engine static`` runs ``greedy_generate``.  Both print the dispatcher's
per-site counters at the end, so every linear, attention and SSD scan call
shows the path it took.  ``--prefill-chunk`` is inert for the ssm and
hybrid families (``--arch mamba2-130m``, ``zamba2-1.2b``), which prefill
monolithically, as in the reference.  ``--share-prefix`` maps repeated
prompt-prefix pages read-only (a ``[shared]`` line of its counters);
``--close-sessions`` then drops each request's cached branch and prints a
``[sessions]`` line.  The overload flags (``--tiers``, ``--tier-q``,
``--deadline-ms``, ``--degrade-queue-depth``, ``--degrade-free-frac``,
``--preempt``) configure the engine's rank tiers, admission policy and
preemption, and print an ``[overload]`` line and one ``[shed]`` line per
shed request.  ``--max-len`` sizes the cache for longer sequences than
``--prompt-len + --gen``; a sliding-window arch (``--arch
h2o-danube-1.8b``) keeps a ring of ``min(max_len, window)`` slots a
sequence whatever it is, so a prompt past the window costs no more cache.
A vlm (``--arch llama-3.2-vision-11b``) or audio (``--arch whisper-small``)
request carries its own image embeddings or audio frames, drawn by
``SyntheticLM`` beside the prompts; both prefill monolithically.
``--replicas N`` serves through a :class:`repro_torch.serving.Cluster`: N
engine replicas, each stepped by its own thread (on the card, on its own
CUDA stream, all sharing one set of weights), behind one shared admission
queue with least-loaded routing, per-replica heartbeats (``--heartbeat-ms``
is the deadline's floor; the deadline adapts up from observed step times)
and bit-exact failover: a dead replica's in-flight requests resume on the
survivors, at most ``--max-failovers`` times each before a structured
``replica_lost`` rejection.  It prints a ``[cluster]`` counters line and
one ``[paged rN]`` line a replica.  ``--event-log PATH`` appends one JSON
line per serving event (shed, degrade, preempt, quarantine, straggler,
failover, replica life cycle), from the single engine too.
The first SIGINT or SIGTERM drains gracefully: the queue
sheds with ``"shutdown"``, in-flight requests finish, and the default
handlers come back (a second signal ends the process).
"""

from __future__ import annotations

import argparse
import signal
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
    ap.add_argument("--share-prefix", action="store_true",
                    help="refcounted copy-on-write prompt-prefix sharing: requests repeating an earlier "
                         "prompt's leading full pages map them read-only and prefill only the unshared tail "
                         "(requires --page-size; inert for families without mid-prompt prefill)")
    ap.add_argument("--warm-cache-pages", type=int, default=0,
                    help="cap on released pages kept matchable in the prefix index (LRU eviction); "
                         "0 = unbounded (requires --page-size)")
    ap.add_argument("--close-sessions", action="store_true",
                    help="after the run, drop each prompt's cached prefix branch (the session-close hook) "
                         "and report the pages freed (requires --share-prefix)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=0,
                    help="positions a sequence may reach (cache size; a sliding window's ring holds "
                         "min(max_len, window)); 0 = --prompt-len + --gen")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = softmax sampling (continuous engine)")
    ap.add_argument("--top-k", type=int, default=0, help="0 = full vocab (continuous engine)")
    ap.add_argument("--compress-alpha", type=float, default=0.0)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--tiers", default="",
                    help="comma-separated rank fractions, the first 1.0 (e.g. '1.0,0.5,0.25'): nested rank tiers "
                         "served from prefix views of the compressed factors (continuous engine; needs "
                         "--compress-alpha to slice anything)")
    ap.add_argument("--tier-q", type=int, default=2, help="power iterations recorded in each tier's certificate")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="shed requests not admitted within this many ms (structured rejection; 0 = none)")
    ap.add_argument("--degrade-queue-depth", type=int, default=0,
                    help="queue depth at which admission degrades new requests to a deeper tier; 0 = off")
    ap.add_argument("--degrade-free-frac", type=float, default=0.0,
                    help="free-page fraction below which admission degrades new requests to a deeper tier; 0 = off")
    ap.add_argument("--preempt", action="store_true",
                    help="a queue head of higher priority may preempt a running request, which resumes as a "
                         "continuation (with --share-prefix, from its own indexed pages)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind one shared admission queue (thread-backed; heartbeat failure "
                         "detection and bit-exact failover; continuous engine only)")
    ap.add_argument("--heartbeat-ms", type=float, default=1000.0,
                    help="replica heartbeat deadline floor; each replica's deadline adapts up from its observed "
                         "step times")
    ap.add_argument("--max-failovers", type=int, default=2,
                    help="failovers per request before it is rejected with reason 'replica_lost'")
    ap.add_argument("--event-log", default="",
                    help="append one JSON line per serving event (shed, degrade, preempt, quarantine, straggler, "
                         "failover, replica life cycle) to this path")
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
    np_batch = data.at_step(0)
    prompts = np.asarray(np_batch["tokens"])
    # the modality stubs beside the prompts: a vlm's image_embed, an audio model's frames
    extras = {k: np.asarray(v) for k, v in np_batch.items() if k != "tokens"}
    max_len = args.max_len or args.prompt_len + args.gen
    if max_len < args.prompt_len + args.gen:
        ap.error(f"--max-len {max_len} < --prompt-len + --gen ({args.prompt_len + args.gen})")
    dcfg = DispatchConfig.from_arch(cfg)
    dispatch.reset_counters()

    if args.engine == "static":
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=dev),
                 **{k: torch.as_tensor(v, device=dev) for k, v in extras.items()}}
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
        from repro_torch.serving import (AdmissionPolicy, Cluster, Engine, EventLog, FailoverBudget, Request,
                                         SamplingParams, percentile)

        tiers = tuple(float(f) for f in args.tiers.split(",") if f) or None
        admission = None
        if args.deadline_ms > 0 or args.degrade_queue_depth > 0 or args.degrade_free_frac > 0:
            admission = AdmissionPolicy(n_tiers=len(tiers) if tiers else 1,
                                        degrade_queue_depth=args.degrade_queue_depth or None,
                                        degrade_free_frac=args.degrade_free_frac or None)
        n_slots = args.n_slots or args.batch
        event_log = EventLog(args.event_log) if args.event_log else None

        def make_engine(rid=0):  # every replica shares the one model and params
            return Engine(model, params, n_slots=n_slots, max_len=max_len, dispatch=dcfg,
                          decode_block=args.decode_block, page_size=args.page_size or None,
                          kv_pages=args.kv_pages or None, prefill_chunk=args.prefill_chunk or None,
                          share_prefix=args.share_prefix, warm_cache_pages=args.warm_cache_pages or None,
                          tiers=tiers, tier_q=args.tier_q, admission=admission, preempt=args.preempt)

        cluster = None
        if args.replicas > 1:
            cluster = Cluster(make_engine, args.replicas, heartbeat_ms=args.heartbeat_ms,
                              budget=FailoverBudget(max_failovers=args.max_failovers, base_ms=10.0),
                              event_log=event_log)
            eng = cluster.replicas[0].eng  # the tiers and their certificates are every replica's
        else:
            eng = make_engine()
            if event_log is not None:
                sink = event_log.sink()
                eng.on_event = sink
                eng.scheduler.on_event = sink
        # one seed per request, so sampled continuations are not correlated across the batch
        reqs = [Request(prompt=prompts[b], max_new_tokens=args.gen,
                        sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                                seed=args.seed + b),
                        extras={k: v[b] for k, v in extras.items()},
                        deadline_ms=args.deadline_ms or None, min_tier=(len(tiers) - 1) if tiers else 0)
                for b in range(args.batch)]

        # graceful drain: the first SIGINT/SIGTERM sheds the queue and lets the
        # in-flight requests finish; the previous handlers then come back, so a
        # second signal acts as usual
        draining = {"on": False}

        def _drain(signum, frame):
            draining["on"] = True
            print(f"\n[drain] caught {signal.Signals(signum).name}: shedding the queue, finishing active slots")
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

        prev_handlers = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev_handlers[sig] = signal.signal(sig, _drain)
            except ValueError:  # not the main thread
                break
        t0 = time.perf_counter()
        try:
            if cluster is not None:
                try:
                    done = cluster.run(reqs, stop=lambda: draining["on"])
                finally:
                    cluster.close()
            else:
                done = eng.run(reqs, stop=lambda: draining["on"])
        finally:
            for sig, handler in prev_handlers.items():
                if signal.getsignal(sig) == _drain:
                    signal.signal(sig, handler)
        dt = time.perf_counter() - t0
        engines = [r.eng for r in cluster.replicas] if cluster is not None else [eng]
        if cluster is not None:
            st = cluster.stats()
            print(f"[cluster] replicas={args.replicas} failovers={st['failovers']} "
                  f"prefix_match={st['failovers_prefix_match']} replica_deaths={st['replica_deaths']} "
                  f"heartbeat_misses={st['heartbeat_misses']} rejoins={st['rejoins']} "
                  f"replica_lost_rejections={st['exhausted']}")
        n_tok = sum(len(r.tokens) for r in done)
        ok = [r for r in done if r.status == "ok"]
        shed = [r for r in done if r.status == "shed"]
        errored = [r for r in done if r.status == "error"]
        print(f"[continuous] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
              f"({n_tok / dt:.1f} tok/s, slots={n_slots}, params {n0/1e6:.1f}M, "
              f"kernels={dcfg.backend}, device={dev}, cuda_graph={eng.cuda_graph})")
        if shed or errored or admission is not None or tiers:
            by_tier = [0] * len(eng.tiers)
            for r in ok:
                by_tier[r.tier] += 1
            certs = " ".join(f"t{i}<= {c.prob_deviation_bound:.3g}" for i, c in enumerate(eng.tier_certificates)
                             if c is not None)
            print(f"[overload] ok={len(ok)} shed={len(shed)} errored={len(errored)} "
                  f"degraded={sum(e.degraded_admissions for e in engines)} "
                  f"preemptions={sum(e.preemptions for e in engines)} "
                  f"quarantined={sum(e.quarantined for e in engines)} tier_counts={by_tier}"
                  + (f" cert_bounds[{certs}]" if certs else ""))
            for r in shed:
                print(f"[shed] uid={r.rejected.uid} reason={r.rejected.reason} waited={r.rejected.waited_ms:.0f}ms "
                      f"queue_depth={r.rejected.queue_depth}")
        lats = sorted(r.latency for r in ok)
        lat_s = (f"p50={percentile(lats, 0.5) * 1e3:.0f}ms p95={percentile(lats, 0.95) * 1e3:.0f}ms"
                 if lats else "p50=n/a p95=n/a (0 completed)")
        syncs = sum(e.host_syncs for e in engines)
        print(f"latency {lat_s} decode_steps={sum(e.steps for e in engines)} host_syncs={syncs} "
              f"graph_replays={sum(e.graph_replays for e in engines)} "
              f"tok_per_sync={sum(e.decoded_tokens for e in engines) / max(syncs, 1):.1f} "
              f"util={sum(e.batch_utilization for e in engines) / len(engines):.3f} "
              f"decode_s={sum(e.decode_seconds for e in engines):.3f} errored={len(errored)}")
        for i, e in enumerate(engines):
            if not e.paged:
                continue
            tag = f" r{i}" if cluster is not None else ""
            print(f"[paged{tag}] page_size={e.page_size} pool={e.kv_pages} pages "
                  f"peak_pages={e.peak_pages_in_use} peak_active={e.peak_active} "
                  f"prefill_chunks={e.prefill_chunks} kv_bytes_cap={e.kv_bytes_capacity} "
                  f"kv_bytes_peak={e.kv_bytes_peak}")
            if args.share_prefix:
                print(f"[shared{tag}] shared_pages={e.shared_page_hits} cow_forks={e.cow_forks} "
                      f"matched_admissions={e.shared_admissions} "
                      f"prefill_tok_skipped={e.skipped_prefill_tokens} "
                      f"cached_pages={e.prefix_cached_pages} evictions={e.prefix_evictions}")
        if args.close_sessions and args.share_prefix and cluster is None:
            freed = sum(eng.drop_session(r.prompt) for r in done)
            print(f"[sessions] closed {len(done)}, freed {freed} cached pages "
                  f"(cached now {eng.prefix_cached_pages})")
        if event_log is not None:
            event_log.close()
            print(f"[events] JSON lines appended to {args.event_log}")
        first = next((r for r in done if r.status == "ok" and r.tokens), None)
        if first is not None:
            print("first sequence:", first.tokens[:12])
        out = done

    print("[dispatch] per-site kernel paths:")
    print(dispatch.format_counters())
    return out


if __name__ == "__main__":
    main()
