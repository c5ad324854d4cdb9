#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean anything) and ``nvcc``.
Imports nothing of JAX and nothing of the reference package ``repro``.
Phases, in order; any failure exits non-zero before the last line:

1. Device: the card's name and power limit; build the four kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, all at once).
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, in bf16 and fp32, with the tolerance stated
   beside each check; times of the kernel, the plain version and one
   PyTorch library call for the same function, and the card's bound.
3. Main path at full width: llama3.2-1b (16 layers, d 2048, bf16, random
   weights from a seed, spectralized to a pretrained-like spectrum), RSI
   compression at alpha 0.3 with q = 1 and q = 4, and greedy generation of
   32 tokens for 4 prompts of 256 tokens with the dense and both compressed
   models.  Gate: q = 4's normalized error <= q = 1's on one w_gate layer.
4. Launches: every kernel ran during phase 3 (counts reset just before).
5. Reference comparison: the q = 4 model's prefill and first decode step
   under backend "auto" (kernels) and "reference" (plain versions).
6. Profile (informational): device time by kernel over a few q = 4 decode
   steps, against the host clock.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 outside them
L2_FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2, written between timed launches

BATCH, PROMPT, GEN = 4, 256, 32
ALPHA = 0.3

REPLACES = {
    "lowrank_matmul": "src/repro/kernels/lowrank_matmul.py:148",
    "decode_attention": "src/repro/kernels/decode_attention.py:92",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "sketch_matmul": "src/repro/kernels/sketch_matmul.py:57",
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "nvidia-smi: n/a"


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
def time_ms(fn, *, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, each launch timed alone with
    CUDA events after the L2 has been flushed (the main path finds each
    layer's weights cold: the other layers' weights pass through L2 in
    between).  A GPU-side spin before each timed launch keeps the device
    behind the host, so the events bracket device work and not the host's
    time to enqueue it."""
    import torch

    flush = time_ms.flush
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of GPU spin, longer than any wrapper's host work
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def bound(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------- #
def check(name, shape, dtype, got, want, rel_tol, reason, *, kernel_fn, plain_fn, library_fn, bytes_moved, ops,
          records):
    """Compare, time, and print one JSON line; keep the first bf16 case of
    each kernel (its main-path representative) for the summary."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ok = err <= rel_tol * scale and bool(torch.isfinite(got.float()).all())
    dname = str(dtype).replace("torch.", "")
    b_ms, b_by = bound(bytes_moved, ops, dname)
    rec = {
        "name": name, "shape": shape, "dtype": dname, "max_abs_err": err, "tol": rel_tol * scale,
        "tol_reason": reason, "ok": ok,
        "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
        "library_ms": time_ms(library_fn) if library_fn is not None else None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    say(json.dumps(rec))
    if not ok:
        fail(f"{name} {shape} {dname}: max abs err {err:.3e} > tol {rel_tol * scale:.3e}")
    if dname == "bfloat16" and name not in records:
        records[name] = rec


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.kernels.sketch_matmul import sketch_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    gemm_tol = {torch.bfloat16: (1e-2, "bf16 outputs (and the rounded x@A) may land one ulp (2^-8) apart "
                                 "where fp32 sums in another order straddle a rounding boundary"),
                torch.float32: (1e-4, "fp32 sums over up to 8192 terms in another order than cuBLAS")}
    attn_tol = {torch.bfloat16: (2e-2, "bf16: p is rounded before PV (unnormalized in the kernel, "
                                 "normalized in the plain decode version) and the output is rounded"),
                torch.float32: (1e-4, "fp32 online softmax vs one-pass softmax, another summation order")}

    # the main path's (K, r, N): wq/wo, wk/wv, w_gate/w_up, w_down at alpha 0.3
    ranks = [(2048, 615, 8192), (2048, 615, 2048), (2048, 154, 512), (8192, 615, 2048)]
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = gemm_tol[dtype]
        for M in (4, 1024):
            for K, r, N in ranks:
                # factors in the storage the model keeps them in (core/lowrank.lowrank_params)
                x, A, B = rnd((M, K), dtype), aligned_rows(rnd((K, r), dtype)), aligned_rows(rnd((r, N), dtype))
                got = lowrank_matmul(x, A, B)
                check("lowrank_matmul", [M, K, r, N], dtype, got, ref.lowrank_matmul_ref(x, A, B), rel, why,
                      kernel_fn=lambda: lowrank_matmul(x, A, B),
                      plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
                      library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
                      bytes_moved=nbytes(x, A, B) + M * N * x.element_size(),
                      ops=2 * M * K * r + 2 * M * r * N, records=records)
                del x, A, B, got

        # RSI's sketch GEMMs on a w_gate-sized W: W @ Y and W^T @ X at l = 615
        C, D, ell = 2048, 8192, 615
        W = rnd((C, D), dtype)
        for trans, other in ((False, (D, ell)), (True, (C, ell))):
            Y = rnd(other, dtype)
            got = sketch_matmul(W, Y, trans_a=trans)
            M_out = D if trans else C
            check("sketch_matmul", [M_out, other[0], ell, "trans_a" if trans else "plain"], dtype, got,
                  ref.sketch_matmul_ref(W, Y, trans_a=trans), rel, why,
                  kernel_fn=lambda: sketch_matmul(W, Y, trans_a=trans),
                  plain_fn=lambda: ref.sketch_matmul_ref(W, Y, trans_a=trans),
                  library_fn=lambda: torch.matmul(W.T if trans else W, Y),
                  bytes_moved=nbytes(W, Y) + M_out * ell * W.element_size(),
                  ops=2 * C * D * ell, records=records)
            del Y, got
        del W

        # decode attention at the main path's decode: B 4, cache 288, GQA 32/8.  First the
        # main path's own mask (the first decode step: prompt + 1 valid positions per row),
        # then a ragged mask with one fully-masked row.
        Bq, S, H, KV, hd = BATCH, PROMPT + GEN, 32, 8, 64
        rel, why = attn_tol[dtype]
        q, k, v = rnd((Bq, 1, H, hd), dtype), rnd((Bq, S, KV, hd), dtype), rnd((Bq, S, KV, hd), dtype)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        prefix = torch.arange(S, device=dev)[None, :].expand(Bq, S) < PROMPT + 1
        ragged = torch.arange(S, device=dev)[None, :] < torch.tensor([S, 100, 0, 0], device=dev)[:, None]
        ragged[3] = torch.rand((S,), generator=gen, device=dev) < 0.5  # ragged pattern; row 2 fully masked
        for label, valid in (("prefix mask", prefix.contiguous()), ("ragged mask", ragged)):
            got = decode_attention(q, k, v, valid)
            if label == "ragged mask" and not bool((got[2] == 0).all()):
                fail("decode_attention: the fully-masked row is not zero")
            mask = valid[:, None, None, :]
            n_rows = int(valid.sum())  # the K/V rows this mask needs: masked rows need not be read
            check("decode_attention", [Bq, S, H, KV, hd, label], dtype, got,
                  ref.decode_attention_ref(q, k, v, valid), rel, why,
                  kernel_fn=lambda: decode_attention(q, k, v, valid),
                  plain_fn=lambda: ref.decode_attention_ref(q, k, v, valid),
                  library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
                  bytes_moved=nbytes(q, valid) + n_rows * KV * 2 * hd * k.element_size()
                  + Bq * H * hd * q.element_size(),
                  ops=4 * H * hd * n_rows, records=records)

        # prefill attention: S 256 (the main path), S 200 (a ragged tile), S 200 with a window
        for S, window in ((PROMPT, None), (200, None), (200, 64)):
            q, k, v = rnd((Bq, S, H, hd), dtype), rnd((Bq, S, KV, hd), dtype), rnd((Bq, S, KV, hd), dtype)
            got = flash_attention(q, k, v, causal=True, window=window)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            pairs = sum(min(i + 1, window or i + 1) for i in range(S))
            # the library call: causal SDPA, or SDPA under the same causal-window mask
            win_mask = ref.attention_mask(S, S, causal=True, window=window, q_offset=0, device=dev)
            check("flash_attention", [Bq, S, H, KV, hd, window], dtype, got,
                  ref.chunked_attention_ref(q, k, v, causal=True, window=window), rel, why,
                  kernel_fn=lambda: flash_attention(q, k, v, causal=True, window=window),
                  plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True, window=window),
                  library_fn=(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True))
                  if window is None else
                  (lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=win_mask, enable_gqa=True)),
                  bytes_moved=nbytes(q, k, v) + q.numel() * q.element_size(),
                  ops=4 * Bq * H * pairs * hd, records=records)

    # the tied-embedding logits through the sketch kernel: fp32 out, unrounded
    E, xT = rnd((128256, 2048), torch.bfloat16), rnd((2048, BATCH), torch.bfloat16)
    rel, why = 1e-4, "fp32 output of bf16 products; only the summation order differs"
    got = sketch_matmul(E, xT, out_dtype=torch.float32)
    check("sketch_matmul", [128256, 2048, BATCH, "logits fp32 out"], torch.float32, got,
          ref.sketch_matmul_ref(E, xT, out_dtype=torch.float32), rel, why,
          kernel_fn=lambda: sketch_matmul(E, xT, out_dtype=torch.float32),
          plain_fn=lambda: ref.sketch_matmul_ref(E, xT, out_dtype=torch.float32),
          library_fn=lambda: torch.matmul(xT.T, E.T),
          bytes_moved=nbytes(E, xT) + 128256 * BATCH * 4, ops=2 * 128256 * 2048 * BATCH, records={})
    del E, xT
    torch.cuda.empty_cache()
    return records


# --------------------------------------------------------------------------- #
# phase 3: the main path at full width
# --------------------------------------------------------------------------- #
def phase_main():
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import decode_attention, flash_attention, lowrank_matmul, sketch_matmul
    from repro_torch.models.model import analytic_param_count, build_model
    from repro_torch.train.serve_step import greedy_generate

    kernels = {"lowrank_matmul": lowrank_matmul.KERNEL, "decode_attention": decode_attention.KERNEL,
               "flash_attention": flash_attention.KERNEL, "sketch_matmul": sketch_matmul.KERNEL}
    cfg = get_arch("llama3.2-1b")
    model = build_model(cfg)  # the card, by default
    dev = model.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    params = spectralize_params(model.init(gen(0)), gen(9))
    torch.cuda.synchronize()
    say(f"[main] llama3.2-1b full width: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.dtype}, "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params; init + spectralize {time.perf_counter() - t0:.1f}s")
    toks = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    max_len = PROMPT + GEN

    def generate(p, label):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = greedy_generate(model, p, batch, steps=GEN, max_len=max_len)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if tuple(out.shape) != (BATCH, GEN) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_padded:
            fail(f"{label}: generated tokens of shape {tuple(out.shape)} out of range")
        say(f"[main] {label}: generated {tuple(out.shape)} in {dt:.3f}s = {BATCH * GEN / dt:.1f} tok/s "
            f"(prefill {BATCH}x{PROMPT} + {GEN - 1} decode steps)")
        return out, BATCH * GEN / dt

    # warm-up (before the counts are reset): one short prefill and decode step,
    # so the first timed generation does not pay CUDA/cuBLAS initialization
    wb = {"tokens": batch["tokens"][:1, :16]}
    wl, wc = model.prefill(params, wb, 17)
    model.decode_step(params, wc, torch.argmax(wl, dim=-1)[:, None], 16)
    torch.cuda.synchronize()

    for k in kernels.values():
        k.reset()
    main_t0 = time.perf_counter()
    dense_out, dense_tps = generate(params, "dense")
    summary = {"dense_tok_s": dense_tps}
    W = params["layers"]["mlp"]["w_gate"][0]
    sv = torch.linalg.svdvals(W.float())
    errs = {}
    compressed = {}
    for q in (1, 4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cp, rep = compress_tree(params, CompressionPolicy(alpha=ALPHA, q=q, min_dim=32), generator=gen(1))
        torch.cuda.synchronize()
        comp_s = time.perf_counter() - t
        ranks = sorted({l.rank for l in rep.layers if l.compressed})
        say(f"[main] compress q={q}: {rep.summary()} ranks {ranks} in {comp_s:.1f}s")
        out, tps = generate(cp, f"alpha={ALPHA} q={q}")
        agree = float((out == dense_out).float().mean())
        gate = cp["layers"]["mlp"]["w_gate"]
        k_rank = gate["a"].shape[-1]
        err = float(normalized_error_factored(W, gate["a"][0], gate["b"][0], sv[k_rank], gen(2), iters=64))
        errs[q] = err
        say(f"[main] q={q}: ratio {rep.ratio:.4f}, token agreement vs dense {agree:.4f}, "
            f"w_gate[0] normalized error ||W-AB||_2/s_(k+1) = {err:.4f} (k={k_rank})")
        summary[f"q{q}"] = {"ratio": rep.ratio, "agreement": agree, "tok_s": tps, "compress_s": comp_s,
                            "normalized_error": err}
        compressed[q] = cp
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    summary["main_path_s"] = time.perf_counter() - main_t0
    summary["launches"] = launches
    say("[main] " + json.dumps(summary))
    if not errs[4] <= errs[1]:
        fail(f"q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return model, compressed[4], batch, launches


# --------------------------------------------------------------------------- #
# phase 5: kernels vs plain versions end to end
# --------------------------------------------------------------------------- #
def phase_reference(model, params, batch):
    import torch

    from repro_torch.runtime.dispatch import use_dispatch

    rel = 5e-2  # of the reference logits' max |value|: bf16 activations through 16 layers, each
    # side rounding the same intermediates but possibly landing one ulp apart
    results = {}
    for backend in ("auto", "reference"):
        with use_dispatch(backend=backend):
            logits, cache = model.prefill(params, batch, PROMPT + GEN)
            tok = torch.argmax(logits, dim=-1)[:, None]
            step_logits, _ = model.decode_step(params, cache, results.get("tok", tok), PROMPT)
        results.setdefault("tok", tok)
        results[backend] = (logits.float(), tok, step_logits.float())
    for i, what in ((0, "prefill logits"), (2, "first decode-step logits")):
        got, want = results["auto"][i], results["reference"][i]
        err, tol = float((got - want).abs().max()), rel * float(want.abs().max())
        say(f"[reference] {what}: max abs err {err:.4e} (tol {tol:.4e} = {rel} x max |reference|)")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail(f"{what}: auto vs reference {err:.4e} > {tol:.4e}")
    # first generated tokens: equal, or the reference's top-2 margin is within the tolerance
    ref_logits = results["reference"][0]
    t_auto, t_ref = results["auto"][1][:, 0], results["reference"][1][:, 0]
    tol = rel * float(ref_logits.abs().max())
    margin = ref_logits.gather(1, t_ref[:, None]) - ref_logits.gather(1, t_auto[:, None])
    same = int((t_auto == t_ref).sum())
    say(f"[reference] first generated tokens agree {same}/{BATCH} (auto {t_auto.tolist()}, "
        f"reference {t_ref.tolist()})")
    if bool((margin[:, 0] > tol).any()):
        fail("first generated tokens differ by more than the logits tolerance")


# --------------------------------------------------------------------------- #
# where a decode step's time goes (after the gated phases; informational)
# --------------------------------------------------------------------------- #
def phase_profile(model, params, batch, steps: int = 4):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits, cache = model.prefill(params, batch, PROMPT + GEN)
    tok = torch.argmax(logits, dim=-1)[:, None]

    def run(first):  # host-clock seconds per decode step over `steps` steps from position `first`
        nonlocal logits, cache, tok
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, tok, first + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / steps

    wall = run(PROMPT)  # profiler off: the idle share is taken against this clock
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run(PROMPT + steps)
    rows = []  # device-side events only: a CPU op's row repeats its kernels' time
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        say(f"[profile] q=4 decode step: wall {wall * 1e3:.3f} ms; device time not measured (no CUDA events)")
        return
    say(f"[profile] q=4 decode step (B={BATCH}, cache {PROMPT + GEN}): wall {wall * 1e3:.3f} ms (profiler off), "
        f"{wall_prof * 1e3:.3f} ms (profiler on); device busy {device_ms:.3f} ms (profiler); "
        f"idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f} of the profiler-off wall")
    for us, n, key in rows[:10]:
        say(f"[profile]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import KERNELS, build_all

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions stay full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    built = build_all()
    say(f"[build] {len(built)} kernel libraries in {time.perf_counter() - t:.1f}s: "
        + ", ".join(p.name for p in built.values()))
    for name, so in built.items():
        log = so.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line:
                    say(f"[ptxas {name}] {line.strip()}")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    t = time.perf_counter()
    records = phase_kernels()
    say(f"[kernels] all checks within tolerance in {time.perf_counter() - t:.1f}s")
    model, params_q4, batch, launches = phase_main()
    phase_reference(model, params_q4, batch)
    phase_profile(model, params_q4, batch)

    line = []
    for name in KERNELS:
        r = records[name]
        line.append({"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
                     "dtype": r["dtype"]})
    say(json.dumps({"kernels": line}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
