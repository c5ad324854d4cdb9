#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py    # every phase; the last line is the result
    python3 chip_smoke.py --lowrank-only [--src DIR]
                             # phase 2's low-rank cases alone, on the package tree DIR
                             # (another checkout's src/, to time its kernels in the same call)
    python3 chip_smoke.py --ssd-only [--src DIR]
                             # phase 2's SSD scan cases alone, likewise
    python3 chip_smoke.py --prefill-only [--src DIR]
                             # the SSM models' profiled 512-token prefill alone, likewise

Needs one CUDA card (an H100 for the numbers to mean anything) and ``nvcc``.
Imports nothing of JAX and nothing of the reference package ``repro``.
Phases, in order; any failure exits non-zero before the last line:

1. Device: the card's name and power limit; build the seven kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, all at once); one line
   a library with its registers, shared memory and spills (ptxas), and the
   tensor-core instructions in the SASS of the seven libraries redesigned
   for Hopper: HGMMA (wgmma) in flash_attention, sketch_matmul and both
   low-rank kernels, HMMA (mma.sync) in the two decode kernels, the
   low-rank kernel's skinny (M <= 8) path and ssd_scan's bf16 kernel.
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, in bf16 and fp32, with the tolerance stated
   beside each check; times of the kernel, the plain version and one
   PyTorch library call for the same function, and the card's bound (and,
   first, what the timing reads for one and two empty launches).  The
   low-rank kernel runs at every main-path M (4 and 8 decode, 256 the
   engine's chunk, 1024 the static prefill) on the four llama shapes, and
   at M 8 on phi3.5-moe's untied head and zamba2's w_x.  The
   sketch GEMM runs on operands in the storage RSI and the logits give it
   (``aligned_rows``), the library call on the same strided views; once
   more on an unaligned Y as a correctness case only; and at phi3.5-moe's
   untied head logits, transposed as the dispatch computes them (and, as a
   comparison only, untransposed).  The
   paged decode kernel also runs on a ragged n_valid with a fully-masked
   row and permuted pages at pages 64, 16 and 128, and at page 64 must
   return the flat kernel's bits.  At phi3.5-moe's shapes: the batched
   low-rank kernel on one layer's expert stacks (decode w_gate and w_down,
   one prefill) with every capacity row live, then the decode stacks at
   the decode occupancy (8 tokens x top-2, numpy seed 0) and a skewed one
   (16 assignments on 2 experts), rows past each count zero (and zero in
   the output); their bound counts the live experts' factors, x read once
   and y written whole.  Then the three attention kernels at head_dim 128.  The SSD
   scan kernel against its plain version at zamba2-1.2b's and
   mamba2-130m's shapes (a prime length and one shorter than a chunk
   among them), under both x̄ contracts, y and the final state, and the
   same bits from a second call at the main-path shape; and the
   three attention kernels at zamba2's shared block, G = 1 (32/32 heads,
   head_dim 64), the paged kernel bit for bit the flat one at page 64.
3. Main path at full width: llama3.2-1b (16 layers, d 2048, bf16, random
   weights from a seed, spectralized to a pretrained-like spectrum), RSI
   compression at alpha 0.3 with q = 1 and q = 4, and greedy generation of
   32 tokens for 4 prompts of 256 tokens with the dense and both compressed
   models.  Gate: q = 4's normalized error <= q = 1's on one w_gate layer.
4. Launches: every kernel of the static path ran during phase 3 (counts
   reset just before); the sketch GEMM's wrapper copied no operand into
   aligned rows there, nor in any compression or engine run.
5. Reference comparison: the q = 4 model's prefill and first decode step
   under backend "auto" (kernels) and "reference" (plain versions).
6. Profile (informational): device time by kernel over a few q = 4 decode
   steps, against the host clock.
7. Serving engine at full width: the q = 4 model behind the
   continuous-batching engine (paged, page 64, 8 slots, max_len 640, 40
   pages = half of flat capacity, prefill chunk 256, decode block 8,
   greedy; the decode block a captured CUDA graph) serving 16 SyntheticLM
   prompts of 32-512 tokens with 16-64 new tokens each, all submitted at
   once.  Gates: every request finishes with its requested token count;
   the graph's tokens equal an eager (``cuda_graph=False``) run's; a paged
   engine's tokens equal a flat engine's (no chunking); a chunked long
   prompt's first-token logits lie within phase 5's tolerance of the
   monolithic prefill's; every kernel of the engine's path launched, and
   decode_attention in the flat run.  Counts are reset just before each
   engine run and read just after it; launches recorded into the graph
   count once per replay.
8. Profiles: host and device time of one captured decode block with all
   8 slots decoding (gate: all 8 active throughout), and the device's idle
   share; the profiler's trace of one block (one replay) must name the
   paged kernel, with one launch of it per paged decode call the block
   makes (its device time beside them), and at most two low-rank launches
   per low-rank call (one a stage) with no split-K reduce pass.  Then one
   (1, 256) prefill chunk:
   host time, and device time split between the hand-written kernels and
   torch's own.
9. The MoE main path at full width: phi3.5-moe (d 4096, 32/8 heads,
   head_dim 128, 16 experts top-2, expert d_ff 6400, vocab 32064, untied
   head, bf16) with n_layers cut 32 -> 4, the only cut (the dense model
   must fit the card before compression); random weights from seed 0,
   spectralized (seed 9), compressed at alpha 0.3, q = 4.  Gate: on layer 0
   expert 0's w_gate, q = 4's normalized error <= q = 1's (the q = 1 run
   factorizes that one matrix).  Ratio, ranks, seconds, peak memory.
10. Phase 5 on the MoE model (the reference replaying the kernel run's
   routing decisions; how many it makes otherwise is printed).
11. Phase 7 on the MoE model, with the batched kernel on its path; its
   paged-vs-flat runs form the same micro-batches, and its chunked-vs-
   monolithic check replays the monolithic routing under a capacity that
   drops nothing.  Gate also: no linear of the main run left the kernels.
12. Phase 8's decode-block profile on the MoE model, with the batched
   kernel's share of the device time (its liveness pass and its expert
   tiles, three launches a call; the trace must name them).
13. The SSM main path at full width and depth: zamba2-1.2b (38 Mamba2
   layers, d 2048, d_inner 4096, 64 SSD heads of 64, state 64; one shared
   attention+MLP block, 32/32 heads, applied 6 times; vocab 32000, untied
   head; bf16), random weights (seed 0), spectralized (seed 9), compressed
   at alpha 0.3, q = 4, min_dim 32.  Gates: the reference's compression
   decisions; on layer 0's w_x, q = 4's normalized error <= q = 1's.
14. Auto vs reference on zamba2, three ways: every residual branch of the
   prefill teacher-forced in bf16 (5% of the branch's output); the
   prefill and first decode-step logits end to end in fp32 (1e-2); the
   same in bf16, within twice the reference's own spread when only its
   scan's summation order changes, + 0.05 (bf16 logits of a deep
   recurrent model are chaotic: one ulp anywhere moves them by percents).
15. Phase 7 on zamba2 (the chunk is inert: the family prefills
   monolithically).  Gates also: every prefill micro-batch holds one prompt
   length, unpadded; ssd_scan launched once per layer per prefill call; no
   linear outside the kernels.
16. Profiles: one captured decode block at 8 slots, and one monolithic
   512-token prefill with ssd_scan's share of the device time and its time
   a launch beside the bound of one call (the prefill also for mamba2-130m
   in phase 17).
17. Phases 13-15 on mamba2-130m at full width and depth (24 layers,
   d 768, 24 SSD heads, state 128, tied head): its engine reserves zero
   pages (no cache leaf is paged), and only its w_dt (768 x 24, below
   min_dim) runs outside the low-rank kernels.

The line before the card line lists every kernel with its time, its
launches on the main run of the newest path that runs it (``launches_run``;
every run's count beside it), bound and library time, the attention
kernels' times at head_dim 128 and at G = 1, the sketch GEMM's at W^T @ X
the tied logits and the untied head's logits, the low-rank kernel's at M 8,
256 and 1024 and the batched kernel's at the decode and skewed
occupancies.  The line before it gives, for the seven kernels redesigned for
Hopper, their earlier times as ``PERF.md`` records them (``[earlier]``:
copied, not measured in the run; the parent's kernels are timed by
``--lowrank-only --src`` or ``--ssd-only --src`` in the same call).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# --src DIR: the package tree to import (default this checkout's src/), so that
# --lowrank-only and --ssd-only can time another checkout's kernels in the same call
SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1]) if "--src" in sys.argv else os.path.join(HERE, "src")
sys.path.insert(0, SRC)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 outside them
L2_FLUSH_BYTES = 256 * 2**20  # > the 50 MB L2, written between timed launches

BATCH, PROMPT, GEN = 4, 256, 32
ALPHA = 0.3

REPLACES = {
    "lowrank_matmul": "src/repro/kernels/lowrank_matmul.py:148",
    "lowrank_matmul_batched": "src/repro/kernels/lowrank_matmul.py:193",
    "decode_attention": "src/repro/kernels/decode_attention.py:92",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "sketch_matmul": "src/repro/kernels/sketch_matmul.py:57",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:153",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:87",
}

# the kernels this round redesigned for Hopper, with the tensor-core instructions their
# libraries' SASS must hold, and their times before it as PERF.md section 6 records them
# (NVIDIA H100 80GB HBM3, 700.00 W), printed on a line of their own: they are not measured
# in the run
REDESIGNED = {"flash_attention": ("HGMMA",), "sketch_matmul": ("HGMMA",), "decode_attention": ("HMMA",),
              "paged_decode_attention": ("HMMA",), "lowrank_matmul": ("HMMA", "HGMMA"),
              "lowrank_matmul_batched": ("HGMMA",), "ssd_scan": ("HMMA",)}
EARLIER_MS = {
    "decode_attention B 4 S 288 hd 64 G 4 prefix mask, split + combine FMA kernels": 0.0208,
    "decode_attention B 8 S 640 hd 128 G 4 ragged mask, split + combine FMA kernels": 0.0398,
    "decode_attention B 8 S 640 hd 64 G 1 ragged mask, split + combine FMA kernels": 0.0502,
    "paged_decode_attention B 8 page 64 n_tbl 10 hd 64 G 4, split + combine FMA kernels": 0.0257,
    "paged_decode_attention B 8 page 64 n_tbl 10 hd 128 G 4, split + combine FMA kernels": 0.0350,
    "paged_decode_attention B 8 page 64 n_tbl 10 hd 64 G 1, split + combine FMA kernels": 0.0259,
    "flash_attention (4, 256) hd 64 G 4, FMA kernel": 0.1378,
    "flash_attention (4, 256) hd 128 G 4, FMA kernel": 0.2655,
    "flash_attention (4, 256) hd 64 G 1, FMA kernel": 0.1402,
    "sketch_matmul 2048x8192 @ 8192x615, WMMA tiles, Y at row stride 615": 0.3700,
    "lowrank_matmul M 4 2048x615x8192, split-K FMA partial + reduce passes": 0.0330,
    "lowrank_matmul_batched 16 x C 128 4096x1229x6400 every row live, 64x64 WMMA tiles": 0.5303,
    "ssd_scan zamba2 (1, 512) 64 x 64 s 64 x̄ rounded, fp32 FMA loops over shared memory": 0.2764,
    "ssd_scan zamba2 (4, 256) 64 x 64 s 64 x̄ rounded, fp32 FMA loops over shared memory": 0.4060,
    "ssd_scan mamba2 (1, 512) 24 x 64 s 128 x̄ rounded, fp32 FMA loops over shared memory": 0.4154,
}

# the MoE main path (phases 9-12): phi3.5-moe at full width, depth cut 32 -> 4
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 4

# the SSM main paths (phases 13-17): zamba2-1.2b at full width and depth, mamba2-130m
SSM_ARCHS = ("zamba2-1.2b", "mamba2-130m")
SSD_CHUNK = 64  # the ssd_scan kernel's own chunk (csrc/ssd_scan.cu)

# the serving engine's main path (phases 7 and 11)
ENGINE = dict(n_slots=8, max_len=640, page_size=64, kv_pages=40, prefill_chunk=256, decode_block=8)
N_REQUESTS, PROMPT_RANGE, GEN_RANGE = 16, (32, 512), (16, 64)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


def ptxas_summary(log: str) -> str:
    """One line from a library's ``nvcc -Xptxas -v`` log: its entries'
    registers, static shared memory, stack and spills."""
    regs, smem, stack, spills = [], [0], [0], 0
    for line in log.splitlines():
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
            sm = re.search(r"(\d+) bytes smem", line)
            smem.append(int(sm.group(1)) if sm else 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            stack.append(int(m.group(1)))
            spills += int(m.group(2)) + int(m.group(3))
    return (f"{len(regs)} kernels: registers {regs} (max {max(regs, default=0)}); static shared memory max "
            f"{max(smem)} bytes; stack max {max(stack)} bytes; spill stores + loads {spills} bytes")


def sass_count(so, opcode: str) -> "int | None":
    """Instructions of ``opcode`` (HGMMA: wgmma; HMMA: mma.sync) in a built
    library's SASS, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {so} failed: {res.stderr[-2000:]}")
    return sum(re.search(rf"\b{opcode}\b", line) is not None for line in res.stdout.splitlines())


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


def launch_floor() -> dict:
    """What ``time_ms`` reads for one and for two back-to-back launches of an
    empty kernel (an 8-element add): the floor under every kernel time of
    phase 2, printed beside them."""
    import torch

    tiny = torch.zeros(8, device="cuda")
    floor = {"one_launch_ms": time_ms(lambda: tiny.add_(1)),
             "two_launches_ms": time_ms(lambda: (tiny.add_(1), tiny.add_(1)))}
    say("[launch floor] " + json.dumps(floor))
    return floor


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
          records, key=None, extra=None):
    """Compare, time, and print one JSON line; keep the first bf16 case of
    each kernel (its main-path representative) for the summary, under
    ``key`` (default the kernel's name).  ``extra``: more fields of the
    record (another bound, the occupancy)."""
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
        "bound_ms": b_ms, "bound_by": b_by, **(extra or {}),
    }
    say(json.dumps(rec))
    if not ok:
        fail(f"{name} {shape} {dname}: max abs err {err:.3e} > tol {rel_tol * scale:.3e}")
    if (key is not None or dname == "bfloat16") and (key or name) not in records:
        records[key or name] = rec


# the 2-D low-rank kernel's main-path shapes (K, r, N): llama's wq/wo, wk/wv, w_gate/w_up and
# w_down at alpha 0.3; phi3.5-moe's compressed untied head (M = 8 slots); zamba2's w_x
LOWRANK_LLAMA = [(2048, 615, 8192), (2048, 615, 2048), (2048, 154, 512), (8192, 615, 2048)]
LOWRANK_M = (4, 8, 256, 1024)  # the static decode, the engine's decode, its prefill chunk, the static prefill
LOWRANK_OTHER = [(8, 4096, 1229, 32064, "phi3.5-moe untied head"), (8, 2048, 615, 4096, "zamba2 w_x")]
# the batched kernel at phi3.5-moe's shapes: 16 experts, rank 1229 (ceil(0.3 * 4096)); (C, K, N)
BATCHED_SHAPES = [(128, 4096, 6400, "decode w_gate"), (128, 6400, 4096, "decode w_down"), (640, 4096, 6400, "prefill")]
MOE_E, MOE_R, MOE_SLOTS, MOE_TOPK = 16, 1229, 8, 2


def moe_decode_counts(occupancy: str):
    """Capacity rows filled per expert: "full" every row; "decode" phi3.5-moe's
    decode occupancy, 8 tokens x top-2 distinct experts drawn with numpy seed
    0; "skewed" all 16 assignments on 2 experts (the synthetic router's skew)."""
    import numpy as np

    if occupancy == "decode":
        rng = np.random.default_rng(0)
        ids = np.stack([rng.choice(MOE_E, size=MOE_TOPK, replace=False) for _ in range(MOE_SLOTS)])
        return np.bincount(ids.reshape(-1), minlength=MOE_E)
    if occupancy == "skewed":
        counts = np.zeros(MOE_E, dtype=np.int64)
        counts[[3, 11]] = MOE_SLOTS
        return counts
    return None


def gemm_tolerances() -> dict:
    """{dtype: (relative tolerance, reason)} of the GEMM kernels against their plain versions."""
    import torch

    return {torch.bfloat16: (1e-2, "bf16 outputs (and the rounded x@A) may land one ulp (2^-8) apart "
                             "where fp32 sums in another order straddle a rounding boundary"),
            torch.float32: (1e-4, "fp32 sums over up to 8192 terms in another order than cuBLAS")}


def phase_lowrank_kernels(rnd, gemm_tol, records):
    """lowrank_matmul at every main-path M (4 and 8 decode, 256 the engine's
    chunk, 1024 the static prefill) on the four llama shapes in bf16, the phi
    head and a zamba2 projection at M 8, and at M 4 and 1024 in fp32; factors
    in the storage the model keeps them in (core/lowrank.lowrank_params)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    cases = [(torch.bfloat16, M, K, r, N, None) for M in LOWRANK_M for K, r, N in LOWRANK_LLAMA]
    cases += [(torch.bfloat16, M, K, r, N, label) for M, K, r, N, label in LOWRANK_OTHER]
    cases += [(torch.float32, M, K, r, N, None) for M in (4, 1024) for K, r, N in LOWRANK_LLAMA]
    for dtype, M, K, r, N, label in cases:
        rel, why = gemm_tol[dtype]
        x, A, B = rnd((M, K), dtype), aligned_rows(rnd((K, r), dtype)), aligned_rows(rnd((r, N), dtype))
        got = lowrank_matmul(x, A, B)
        # each M's w_gate case is its summary row (M 4 under the kernel's own name)
        key = None if dtype != torch.bfloat16 or (K, r, N) != LOWRANK_LLAMA[0] or label else (
            "lowrank_matmul" if M == LOWRANK_M[0] else f"lowrank_matmul M {M}")
        check("lowrank_matmul", [M, K, r, N] + ([label] if label else []), dtype, got,
              ref.lowrank_matmul_ref(x, A, B), rel, why,
              kernel_fn=lambda: lowrank_matmul(x, A, B),
              plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
              bytes_moved=nbytes(x, A, B) + M * N * x.element_size(),
              ops=2 * M * K * r + 2 * M * r * N, records=records if key else {}, key=key)
        del x, A, B, got
    torch.cuda.empty_cache()


def phase_batched_kernels(rnd, gemm_tol, records):
    """lowrank_matmul_batched on one layer's expert stacks at phi3.5-moe's
    shapes (factors as a view of a row-padded (L, E, K, r) leaf): every
    capacity row live (bf16 and fp32), then in bf16 at the decode occupancy
    and a skewed one, rows past each expert's count exact zeros.  The bound
    of an occupancy counts what its inputs need: the factors of the experts
    with a live row, x read once, y written whole (``bound_all_ms``: every
    expert's factors)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.lowrank_matmul_batched import lowrank_matmul_batched

    dev = torch.device("cuda")
    E, r = MOE_E, MOE_R
    cases = [(dtype, C, K, N, label, "full") for dtype in (torch.bfloat16, torch.float32)
             for C, K, N, label in BATCHED_SHAPES]
    cases += [(torch.bfloat16, C, K, N, label, occ) for occ in ("decode", "skewed")
              for C, K, N, label in BATCHED_SHAPES[:2]]
    for dtype, C, K, N, label, occ in cases:
        rel, why = gemm_tol[dtype]
        x = rnd((E, C, K), dtype)
        counts = moe_decode_counts(occ)
        if counts is not None:  # rows past each count: exact zeros, as models/moe.py leaves them
            live = torch.arange(C, device=dev)[None, :] < torch.as_tensor(counts, device=dev)[:, None]
            x = torch.where(live[..., None], x, torch.zeros((), dtype=dtype, device=dev))
        n_live = E if counts is None else int((counts > 0).sum())
        rows = E * C if counts is None else int(counts.sum())
        # one layer's slice of an (L, E, K, r) factor leaf, stored as compress_tree stores it
        A = aligned_rows(rnd((1, E, K, r), dtype))[0]
        B = aligned_rows(rnd((1, E, r, N), dtype))[0]
        got = lowrank_matmul_batched(x, A, B)
        want = ref.lowrank_matmul_ref(x, A, B)
        if counts is not None and not bool((got[~live] == 0).all()):
            fail(f"lowrank_matmul_batched {label} at the {occ} occupancy: a row past its expert's count is not zero")
        esz = x.element_size()
        factor = (K * r + r * N) * esz  # one expert's factors
        xy = nbytes(x) + E * C * N * esz
        all_ms, all_by = bound(E * factor + xy, 2 * E * C * (K * r + r * N), str(dtype).replace("torch.", ""))
        key = f"lowrank_matmul_batched {occ}" if occ != "full" and label == "decode w_gate" else None
        check("lowrank_matmul_batched", [E, C, K, r, N, label, f"{occ} occupancy"], dtype, got, want, rel, why,
              kernel_fn=lambda: lowrank_matmul_batched(x, A, B),
              plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.bmm(torch.bmm(x, A), B),  # bmm rounds t to x's dtype, as the kernel
              bytes_moved=n_live * factor + xy, ops=2 * rows * (K * r + r * N),
              records=records if occ == "full" or key else {}, key=key,
              extra={"live_experts": n_live, "live_rows": rows, "bound_all_ms": all_ms, "bound_all_by": all_by})
        del x, A, B, got, want
    torch.cuda.empty_cache()


def phase_lowrank_only() -> int:
    """``--lowrank-only``: phase 2's low-rank cases alone, on the tree ``--src``
    names (another checkout's kernels, timed in the same call as this one's)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[lowrank-only] {card_line()}; package tree {SRC}")
    build_all(["lowrank_matmul", "lowrank_matmul_batched"])
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    launch_floor()
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    phase_lowrank_kernels(rnd, gemm_tolerances(), records)
    phase_batched_kernels(rnd, gemm_tolerances(), records)
    say("[lowrank-only] " + json.dumps({k: {f: v[f] for f in ("shape", "ms", "library_ms", "bound_ms")}
                                        for k, v in records.items()}))
    return 0


def phase_ssd_only() -> int:
    """``--ssd-only``: phase 2's SSD scan cases alone, on the tree ``--src``
    names (another checkout's kernel, timed in the same call as this one's)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    say(f"[ssd-only] {card_line()}; package tree {SRC}")
    build_all(["ssd_scan"])
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    launch_floor()
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    phase_ssd_kernels(rnd, gen, records)
    say("[ssd-only] " + json.dumps({k: {f: v[f] for f in ("shape", "ms", "plain_ms", "bound_ms")}
                                    for k, v in records.items() if k != "ssd_scan"}))
    from repro_torch.kernels import ssd_scan as ssd_mod

    if hasattr(ssd_mod, "ssd_plan"):  # the plan's inputs, on trees that have it
        ssd_plan_inputs(rnd, gen)
    return 0


def _ssd_launcher(fn, B, L, nh, hd, s, rnd, gen, cols):
    """A closure launching ``fn`` (``ssd_scan_bf16``'s arguments but the
    stream; returns a CUDA error code) on fresh inputs at ``cols`` columns a
    block, clustered as the plan clusters them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import cluster_size

    x = rnd((B, L, nh, hd), torch.bfloat16, scale=1.0)
    dt = F.softplus(torch.randn((B, L, nh), generator=gen, device="cuda"))
    Bm, Cm = rnd((B, L, s), torch.bfloat16, scale=s**0.5), rnd((B, L, s), torch.bfloat16, scale=s**0.5)
    A = -torch.linspace(1.0, 16.0, nh, device="cuda")
    y, st = torch.empty_like(x), torch.empty((B, nh, hd, s), device="cuda")

    def run():
        code = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), y.data_ptr(),
                  st.data_ptr(), B, L, nh, hd, s, 1, cols, cluster_size(hd // cols))
        if code != 0:
            fail(f"ssd_scan_bf16 at {cols} columns: CUDA error {code}")
    return run


def ssd_plan_inputs(rnd, gen) -> None:
    """What the plan and the design rest on, bf16, x̄ rounded: the kernel's
    time at both column tiles on the three main-path shapes (the plan's pick
    marked), over L at zamba2's head shape, and with its C B^T products taken
    out (a copy of the source built without them: wrong results, timed only),
    whose saving is C B^T's share of the call."""
    import ctypes

    import torch

    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

    def fn(*args):
        ssd_mod.KERNEL.launch("ssd_scan_bf16", torch.device("cuda"), *args)  # raises on an error
        return 0

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in ((1, 512, 64, 64, 64), (4, 256, 64, 64, 64), (1, 512, 24, 64, 128)):
        ms = {c: time_ms(_ssd_launcher(fn, *shape, rnd, gen, c)) for c in ssd_mod.COLS}
        say("[ssd plan] " + json.dumps({"shape": list(shape), "ms_by_cols": ms,
                                        "plan_cols": ssd_mod.ssd_plan(*shape, torch.bfloat16, n_sms).cols}))
    cols = ssd_mod.ssd_plan(1, 512, 64, 64, 64, torch.bfloat16, n_sms).cols
    say("[ssd plan] zamba2 head shape over L, ms: " + json.dumps(
        {L: time_ms(_ssd_launcher(fn, 1, L, 64, 64, 64, rnd, gen, cols)) for L in (64, 128, 256, 512, 1024, 2048)}))
    src = (CSRC / "ssd_scan.cu").read_text()
    cut = ("mma_16816(g[0], ca, bb[0], bb[1]);", "mma_16816(g[1], ca, bb[2], bb[3]);")
    if not all(c in src for c in cut):
        fail("ssd_scan.cu: the C B^T products to take out are not found")
    for c in cut:
        src = src.replace(c, "")
    cu, so = CSRC / "_ssd_no_cb.cu", BUILD_DIR / "ssd_scan_no_cb.so"
    cu.write_text(src)
    try:
        res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True,
                             timeout=600)
    finally:
        cu.unlink()
    if res.returncode != 0:
        fail(f"nvcc failed for ssd_scan without C B^T: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so)).ssd_scan_bf16
    lib.argtypes, lib.restype = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int

    def no_cb(*args):
        return lib(*args, torch.cuda.current_stream().cuda_stream)

    for shape in ((1, 512, 64, 64, 64), (1, 512, 24, 64, 128)):
        c = ssd_mod.ssd_plan(*shape, torch.bfloat16, n_sms).cols
        full, cut_ms = time_ms(_ssd_launcher(fn, *shape, rnd, gen, c)), time_ms(_ssd_launcher(no_cb, *shape, rnd, gen, c))
        say("[ssd plan] " + json.dumps({"shape": list(shape), "cols": c, "ms": full, "ms_without_cb": cut_ms,
                                        "cb_share": 1 - cut_ms / full}))


def phase_prefill_only() -> int:
    """``--prefill-only``: the SSM models of phases 13 and 17 (set up and
    compressed as there) and one profiled monolithic 512-token prefill each,
    on the tree ``--src`` names (another checkout's kernels, timed in the
    same call as this one's)."""
    import gc

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[prefill-only] {card_line()}; package tree {SRC}")
    build_all()
    for arch in SSM_ARCHS:
        tag = arch.split("-")[0]
        model, params, _, _, _ = phase_ssm_main(arch)
        say("[prefill-only] " + json.dumps({"arch": arch, **phase_prefill_profile(model, params, tag=f"{tag} prefill")}))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.sketch_matmul import sketch_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    launch_floor()
    gemm_tol = gemm_tolerances()
    attn_tol = {torch.bfloat16: (2e-2, "bf16: p is rounded before PV (unnormalized in the kernel, "
                                 "normalized in the plain decode version) and the output is rounded"),
                torch.float32: (1e-4, "fp32 online softmax vs one-pass softmax, another summation order")}

    phase_lowrank_kernels(rnd, gemm_tol, records)
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = gemm_tol[dtype]
        # RSI's sketch GEMMs on a w_gate-sized W: W @ Y and W^T @ X at l = 615, with Y and X in
        # the storage core/rsi.py gives them (aligned_rows: row stride 616); torch.matmul gets
        # the same strided views.  Then once more on a contiguous (unaligned, row stride 615)
        # Y: a correctness case only, which the wrapper copies into aligned rows first.
        C, D, ell = 2048, 8192, 615
        W = rnd((C, D), dtype)
        for trans, other, storage in ((False, (D, ell), "aligned_rows"), (True, (C, ell), "aligned_rows"),
                                      (False, (D, ell), "unaligned, correctness only")):
            Y = aligned_rows(rnd(other, dtype)) if storage == "aligned_rows" else rnd(other, dtype)
            got = sketch_matmul(W, Y, trans_a=trans)
            M_out = D if trans else C
            check("sketch_matmul", [M_out, other[0], ell, "trans_a" if trans else "plain", storage], dtype, got,
                  ref.sketch_matmul_ref(W, Y, trans_a=trans), rel, why,
                  kernel_fn=lambda: sketch_matmul(W, Y, trans_a=trans),
                  plain_fn=lambda: ref.sketch_matmul_ref(W, Y, trans_a=trans),
                  library_fn=lambda: torch.matmul(W.T if trans else W, Y),
                  bytes_moved=nbytes(W, Y) + M_out * ell * W.element_size(),
                  ops=2 * C * D * ell, records=records if storage == "aligned_rows" else {},
                  key="sketch_matmul trans_a" if trans else "sketch_matmul")
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

    phase_paged_kernel(rnd, gen, attn_tol, records)
    phi = phase_moe_kernels(rnd, gen, gemm_tol, attn_tol, records)
    g1 = phase_ssm_kernels(rnd, gen, records)

    # the tied-embedding logits through the sketch kernel: fp32 out, unrounded; x^T in the
    # storage runtime/dispatch.logits_apply gives it (aligned_rows: row stride 8)
    E, xT = rnd((128256, 2048), torch.bfloat16), aligned_rows(rnd((2048, BATCH), torch.bfloat16))
    rel, why = 1e-4, "fp32 output of bf16 products; only the summation order differs"
    got = sketch_matmul(E, xT, out_dtype=torch.float32)
    check("sketch_matmul", [128256, 2048, BATCH, "logits fp32 out"], torch.float32, got,
          ref.sketch_matmul_ref(E, xT, out_dtype=torch.float32), rel, why,
          kernel_fn=lambda: sketch_matmul(E, xT, out_dtype=torch.float32),
          plain_fn=lambda: ref.sketch_matmul_ref(E, xT, out_dtype=torch.float32),
          library_fn=lambda: torch.matmul(xT.T, E.T),
          bytes_moved=nbytes(E, xT) + 128256 * BATCH * 4, ops=2 * 128256 * 2048 * BATCH, records=records,
          key="sketch_matmul logits")
    del E, xT

    # the untied head's logits (phi3.5-moe: d 4096, V 32064) for the slots of one decode
    # step, as runtime/dispatch.logits_apply computes them: head^T @ x^T, the stored (d, V)
    # head read in place as the MN-major A operand, x^T in aligned_rows.  Then the same
    # product in the form x @ head (8 rows of a 256-row tile): a comparison only.
    d, V, n = 4096, 32064, ENGINE["n_slots"]
    head, x = rnd((d, V), torch.bfloat16), rnd((n, d), torch.bfloat16)
    xT = aligned_rows(x.T)
    forms = (("head^T @ x^T", lambda: sketch_matmul(head, xT, trans_a=True, out_dtype=torch.float32).T),
             ("x @ head, comparison only", lambda: sketch_matmul(x, head, out_dtype=torch.float32)))
    for label, fn in forms:
        main_form = label == "head^T @ x^T"
        check("sketch_matmul", [n, d, V, f"untied head logits fp32 out, {label}"], torch.float32, fn(),
              ref.sketch_matmul_ref(x, head, out_dtype=torch.float32), rel, why,
              kernel_fn=fn, plain_fn=lambda: ref.sketch_matmul_ref(x, head, out_dtype=torch.float32),
              library_fn=lambda: torch.matmul(x, head),
              bytes_moved=nbytes(head, x) + n * V * 4, ops=2 * n * d * V,
              records=records if main_form else {}, key="sketch_matmul untied head")
    del head, x, xT
    torch.cuda.empty_cache()
    return records, phi, g1


def phase_moe_kernels(rnd, gen, gemm_tol, attn_tol, records):
    """The MoE path's kernels at phi3.5-moe's shapes: the batched low-rank
    kernel on one layer's expert stacks (16 experts, rank 1229, factors as a
    view of a row-padded (L, E, K, r) leaf), and the three attention kernels
    at 32/8 heads, head_dim 128.  Returns {kernel: bf16 record} of the
    attention kernels at head_dim 128."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention

    phase_batched_kernels(rnd, gemm_tol, records)

    dev = torch.device("cuda")
    phi: dict = {}
    H, KV, hd = 32, 8, 128
    Bq = ENGINE["n_slots"]
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        # prefill: phase 10's (4, 256)
        q, k, v = rnd((BATCH, PROMPT, H, hd), dtype), rnd((BATCH, PROMPT, KV, hd), dtype), rnd((BATCH, PROMPT, KV, hd), dtype)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention(q, k, v, causal=True)
        pairs = PROMPT * (PROMPT + 1) // 2
        check("flash_attention", [BATCH, PROMPT, H, KV, hd, None], dtype, got,
              ref.chunked_attention_ref(q, k, v, causal=True), rel, why,
              kernel_fn=lambda: flash_attention(q, k, v, causal=True),
              plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True),
              bytes_moved=nbytes(q, k, v) + q.numel() * q.element_size(), ops=4 * BATCH * H * pairs * hd,
              records=phi)
        # decode over the flat engine's cache: 8 slots, max_len 640, ragged fill, one empty slot
        S = ENGINE["max_len"]
        q, k, v = rnd((Bq, 1, H, hd), dtype), rnd((Bq, S, KV, hd), dtype), rnd((Bq, S, KV, hd), dtype)
        n_valid = torch.tensor([S, 1, 0, 65, 191, 100, S // 2, 7], device=dev)
        valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
        got = decode_attention(q, k, v, valid)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = valid[:, None, None, :]
        n_rows = int(valid.sum())
        check("decode_attention", [Bq, S, H, KV, hd, "ragged mask"], dtype, got,
              ref.decode_attention_ref(q, k, v, valid), rel, why,
              kernel_fn=lambda: decode_attention(q, k, v, valid),
              plain_fn=lambda: ref.decode_attention_ref(q, k, v, valid),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
              bytes_moved=nbytes(q, valid) + n_rows * KV * 2 * hd * k.element_size() + Bq * H * hd * q.element_size(),
              ops=4 * H * hd * n_rows, records=phi)
        # paged decode through the engine's block table: page 64, 10 pages a slot
        page, n_tbl = ENGINE["page_size"], -(-ENGINE["max_len"] // ENGINE["page_size"])
        P = Bq * n_tbl + 1
        kp, vp = rnd((P, page, KV, hd), dtype), rnd((P, page, KV, hd), dtype)
        kp[-1], vp[-1] = 1e4, -1e4
        bt = torch.randperm(P - 1, generator=gen, device=dev)[: Bq * n_tbl].reshape(Bq, n_tbl).to(torch.int32)
        nv = n_valid.to(torch.int32)
        got = paged_decode_attention(q, kp, vp, bt, nv)
        flat = decode_attention(q, ref.gather_pages(kp, bt), ref.gather_pages(vp, bt), valid)
        if not bool(torch.equal(got, flat)):
            fail(f"paged_decode_attention at page 64, head_dim 128 ({dtype}) differs from the flat kernel")
        ks, vs = ref.gather_pages(kp, bt).transpose(1, 2), ref.gather_pages(vp, bt).transpose(1, 2)
        check("paged_decode_attention", [Bq, page, n_tbl, H, KV, hd, "ragged n_valid"], dtype, got,
              ref.paged_decode_attention_ref(q, kp, vp, bt, nv), rel, why,
              kernel_fn=lambda: paged_decode_attention(q, kp, vp, bt, nv),
              plain_fn=lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, nv),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
              bytes_moved=nbytes(q, bt, nv) + n_rows * KV * 2 * hd * kp.element_size() + Bq * H * hd * q.element_size(),
              ops=4 * H * hd * n_rows, records=phi)
        say(f"[phi kernels] paged == flat kernel bit for bit at page 64, head_dim 128, {dtype}: True")
        del q, k, v, kp, vp, qs, ks, vs, got, flat
    torch.cuda.empty_cache()
    return phi


def phase_paged_kernel(rnd, gen, attn_tol, records):
    """The paged decode kernel against its plain version, and bitwise against
    the flat kernel at page 64."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention

    dev = torch.device("cuda")
    Bq, H, KV, hd = ENGINE["n_slots"], 32, 8, 64
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        for page, n_tbl in ((64, 10), (16, 40), (128, 5)):
            S = n_tbl * page
            P = Bq * n_tbl + 1
            q, k, v = rnd((Bq, 1, H, hd), dtype), rnd((P, page, KV, hd), dtype), rnd((P, page, KV, hd), dtype)
            k[-1], v[-1] = 1e4, -1e4  # the trash page: finite poison, never attended
            perm = torch.randperm(P - 1, generator=gen, device=dev)[: Bq * n_tbl]
            bt = perm.reshape(Bq, n_tbl).to(torch.int32).contiguous()
            # ragged, crossing page boundaries; row 2 fully masked; row 5 past n_valid on trash
            n_valid = torch.tensor([S, 1, 0, page + 1, 3 * page - 1, 100, S // 2, 7], dtype=torch.int32,
                                   device=dev)
            bt[5, -1] = P - 1
            got = paged_decode_attention(q, k, v, bt, n_valid)
            if not bool((got[2] == 0).all()):
                fail("paged_decode_attention: the fully-masked row is not zero")
            flat_k, flat_v = ref.gather_pages(k, bt), ref.gather_pages(v, bt)
            valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
            if page == 64:
                flat = decode_attention(q, flat_k, flat_v, valid)
                same = bool(torch.equal(got, flat))
                say(f"[paged] page 64 {dtype}: paged == flat kernel bit for bit: {same}")
                if not same:
                    fail(f"paged_decode_attention at page 64 ({dtype}) differs from the flat kernel")
            qs, ks, vs = q.transpose(1, 2), flat_k.transpose(1, 2), flat_v.transpose(1, 2)
            mask = valid[:, None, None, :]
            n_rows = int(n_valid.sum())  # the K/V rows n_valid keeps: the rest need not be read
            check("paged_decode_attention", [Bq, page, n_tbl, H, KV, hd, "ragged n_valid"], dtype, got,
                  ref.paged_decode_attention_ref(q, k, v, bt, n_valid), rel, why,
                  kernel_fn=lambda: paged_decode_attention(q, k, v, bt, n_valid),
                  plain_fn=lambda: ref.paged_decode_attention_ref(q, k, v, bt, n_valid),
                  # SDPA on the pre-gathered cache: the gather is not timed
                  library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
                  bytes_moved=nbytes(q, bt, n_valid) + n_rows * KV * 2 * hd * k.element_size()
                  + Bq * H * hd * q.element_size(),
                  ops=4 * H * hd * n_rows, records=records)
            del q, k, v, flat_k, flat_v, qs, ks, vs


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
    sketch_matmul.ALIGN_COPIES.reset()
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
    no_align_copies("the llama3.2-1b static run (compression and generation)")
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
def routed(fn, replay=None):
    """Run ``fn()`` with every moe layer's routing recorded, through the
    port's own ``_route``.  Returns (fn's result, [(expert ids the call used
    (T, K), its own top-k ids (T, K), its fp32 router logits (T, E)) per
    routed call]); no calls for a dense model.  With ``replay`` (expert ids
    per routed call of an earlier run), each call takes the replayed ids in
    place of its own top-k (for its first rows, where the replayed ids cover
    fewer rows than the call routes), and as gates the renormalized
    probabilities of those experts, as ``_route`` computes gates."""
    import torch

    from repro_torch.models import moe as moe_mod

    seen = []
    route = moe_mod._route

    def hook(xf, gate_w, cfg):
        own, gates, probs = route(xf, gate_w, cfg)
        ids = own
        if replay is not None:
            head = replay[len(seen)]
            ids = torch.cat([head, own[head.shape[0]:]])
            gates = probs.gather(1, ids)
            gates = gates / gates.sum(dim=-1, keepdim=True)
        seen.append((ids, own, torch.matmul(xf.float(), gate_w.float())))
        return ids, gates, probs

    moe_mod._route = hook
    try:
        return fn(), seen
    finally:
        moe_mod._route = route


def routing_gate(tag: str, what: str, pairs, rel: float) -> None:
    """Gate a run that replayed another run's routing.  ``pairs``: per
    routed call, (the ids it replayed, its own top-k ids, its own router
    logits, the replayed run's router logits), rows aligned.  The replay
    hides only decisions that are rounding away from a tie, so: the two
    runs' router logits agree within ``rel`` of the replayed run's max
    |logit| (the tolerance the model's logits are held to), and a token
    whose own expert set differs from the replayed one does so by a logit
    margin (its largest own-only expert logit less its smallest
    replayed-only one) within that same tolerance."""
    import torch

    flips = total = 0
    worst_err, worst_margin = (0.0, 1.0), (0.0, 1.0)  # (value, its call's tol), the largest value / tol
    for used, own, z, z_src in pairs:
        tol = rel * float(z_src.abs().max())
        err = float((z - z_src).abs().max())
        if err / tol >= worst_err[0] / worst_err[1]:
            worst_err = (err, tol)
        own_m = torch.zeros_like(z, dtype=torch.bool).scatter_(1, own, True)
        used_m = torch.zeros_like(z, dtype=torch.bool).scatter_(1, used, True)
        differ = (own_m != used_m).any(dim=1)
        flips += int(differ.sum())
        total += z.shape[0]
        if bool(differ.any()):
            zz = z[differ]
            margin = float((zz.masked_fill(~(own_m & ~used_m)[differ], float("-inf")).amax(dim=1)
                            - zz.masked_fill(~(used_m & ~own_m)[differ], float("inf")).amin(dim=1)).max())
            if margin / tol >= worst_margin[0] / worst_margin[1]:
                worst_margin = (margin, tol)
    say(f"[{tag}] {what} routing: router logits max abs err {worst_err[0]:.4e} (tol {worst_err[1]:.4e} = {rel} x "
        f"max |replayed run's router logits|); tokens whose own expert set differs from the replayed one "
        f"{flips}/{total}" + (f", largest logit margin {worst_margin[0]:.4e} (tol {worst_margin[1]:.4e})"
                              if flips else ""))
    if worst_err[0] > worst_err[1] or worst_margin[0] > worst_margin[1]:
        fail(f"{tag}: {what} routing is not within rounding of the replayed run's")


def phase_blocks_reference(model, params, batch, tag: str, rel: float = 5e-2) -> float:
    """Branch by branch, teacher-forced: every residual branch of the prefill
    (each Mamba2 layer's mixer; a hybrid shared block's attention and its
    MLP) run under "auto" and under "reference" on the SAME input, built
    from the reference run's branches before it.  Each branch's output must
    agree within ``rel`` of its largest value: one branch's chain of bf16
    kernels, each within 1e-2 of its plain version in phase 2, and nothing
    carried over from the layers before.  (The branches are compared before
    the residual add: a one-ulp difference of a branch can flip the bf16
    rounding of the much larger residual sum by one ulp of the sum.)
    Returns the worst error / tolerance ratio."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import modules as nn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.dispatch import use_dispatch

    cfg = model.cfg
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = nn.embed_lookup(params["embed"], tokens)
    worst, where, n = 0.0, None, 0

    def branch(label, fn):
        nonlocal worst, where, n
        outs = {}
        for backend in ("auto", "reference"):
            with use_dispatch(backend=backend):
                outs[backend] = fn()
        err = float((outs["auto"].float() - outs["reference"].float()).abs().max())
        tol = rel * float(outs["reference"].float().abs().max())
        if not (err <= tol and bool(torch.isfinite(outs["auto"]).all())):
            fail(f"{tag}: branch {label}: auto vs reference {err:.4e} > {tol:.4e}")
        if err / tol >= worst:
            worst, where = err / tol, f"{label}: err {err:.4e}, tol {tol:.4e}"
        n += 1
        return outs["reference"]

    for kind, i in lm_mod._schedule(cfg):
        if kind == "shared":
            p = params["shared_attn"]
            h = nn.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            x = x + branch(f"shared block {i} attention", lambda: attn.gqa_forward(p["attn"], h, cfg,
                                                                                     positions=positions))
            h = nn.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
            x = x + branch(f"shared block {i} mlp", lambda: moe_mod.ffn_forward(p["mlp"], h))
        else:
            lp = lm_mod._layer(params["layers"], i)
            h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
            x = x + branch(f"layer {i} mamba", lambda: ssm_mod.mamba2_forward(lp["mamba"], h, cfg))
    say(f"[{tag}] every prefill branch teacher-forced (auto vs reference on the same input, {B}x{S} tokens): "
        f"within {rel} x max |branch output| in all {n} branches; worst {where} (ratio {worst:.3f})")
    return worst


def phase_ssm_reference(model, params, batch, tag: str) -> dict:
    """Auto vs reference end to end for the recurrent families: the prefill
    logits and the first decode step's (both runs fed auto's first token).

    In fp32 the kernels differ from their plain versions by summation order
    only (each within 1e-4 in phase 2): held to 1e-2 of max |logit|, room
    for the recurrent layers' amplification of that.  In bf16 a one-ulp
    difference anywhere is amplified through 38 (24) recurrent layers as
    much as the model's own bf16 rounding is: the reference itself, with
    only its scan's summation order changed (the plain scan at the kernel's
    64-step chunk against its own chunk rule), moves by ``spread``.  So bf16
    is held to 2 x spread + 0.05 of max |logit|, which a wrong kernel (O(1)
    off) cannot meet; the branch-by-branch check (phase_blocks_reference)
    holds each kernel to its bf16 tolerance in place."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.runtime.dispatch import use_dispatch

    def run(m, p, backend, tok=None):
        with use_dispatch(backend=backend):
            logits, cache = m.prefill(p, batch, PROMPT + GEN)
            tok = torch.argmax(logits, dim=-1)[:, None] if tok is None else tok
            step, _ = m.decode_step(p, cache, tok, PROMPT)
        return logits.float(), tok, step.float()

    def err(a, b, i):
        return float((a[i] - b[i]).abs().max()) / float(b[i].abs().max())

    def to32(t):
        return {k: to32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    out = {}
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = to32(params)
    auto = run(m32, p32, "auto")
    ref = run(m32, p32, "reference", auto[1])
    for i, what, key in ((0, "prefill", "prefill"), (2, "first decode step", "decode")):
        e = err(auto, ref, i)
        out[f"fp32_{key}"] = e
        say(f"[{tag}] fp32 {what} logits: auto vs reference max abs err {e:.4e} x max |reference| (tol 1e-2)")
        if not (e <= 1e-2 and bool(torch.isfinite(auto[i]).all())):
            fail(f"{tag}: fp32 {what} logits, auto vs reference {e:.4e} > 1e-2 x max |reference|")
    del m32, p32, auto, ref
    torch.cuda.empty_cache()

    auto = run(model, params, "auto")
    ref = run(model, params, "reference", auto[1])
    moved = run(build_model(dataclasses.replace(model.cfg, ssm_chunk=SSD_CHUNK)), params, "reference", auto[1])
    for i, what, key in ((0, "prefill", "prefill"), (2, "first decode step", "decode")):
        e, spread = err(auto, ref, i), err(moved, ref, i)
        tol = 2 * spread + 0.05
        out[f"bf16_{key}"], out[f"bf16_{key}_spread"] = e, spread
        say(f"[{tag}] bf16 {what} logits: auto vs reference max abs err {e:.4e} x max |reference|; the "
            f"reference at scan chunk {SSD_CHUNK} vs its own rule {spread:.4e}; tol 2 x that + 0.05 = {tol:.4e}")
        if not (e <= tol and bool(torch.isfinite(auto[i]).all())):
            fail(f"{tag}: bf16 {what} logits, auto vs reference {e:.4e} > {tol:.4e}")
    same = int((auto[1] == run(model, params, "reference")[1]).sum())
    say(f"[{tag}] first generated tokens, auto vs reference: {same}/{auto[1].shape[0]} equal")
    return out


def phase_reference(model, params, batch, tag: str = "reference"):
    """The model under backend "auto" (kernels) against "reference" (plain
    versions): prefill logits and the first decode step's.  A moe layer's
    top-k is discontinuous: two runs that differ by a bf16 ulp can send a
    near-tied token to another expert, and that token's hidden state then
    differs by far more than rounding.  So for a moe model the reference
    runs with the kernel run's routing decisions replayed (every other
    operation its own), and ``routing_gate`` holds each replayed decision
    to a near tie in the reference's own router logits.  Routing is the
    same torch code under both backends: no kernel of its own is hidden by
    the replay."""
    import torch

    from repro_torch.runtime.dispatch import use_dispatch

    rel = 5e-2  # of the reference logits' max |value|: bf16 activations through every layer, each
    # side rounding the same intermediates but possibly landing one ulp apart
    results, recorded = {}, {}
    for backend in ("auto", "reference"):
        replay = [None, None] if backend == "auto" or not recorded["auto"][0] else \
            [[used for used, _, _ in rec] for rec in recorded["auto"]]
        with use_dispatch(backend=backend):
            (logits, cache), rec_p = routed(lambda: model.prefill(params, batch, PROMPT + GEN), replay[0])
            tok = torch.argmax(logits, dim=-1)[:, None]
            (step_logits, _), rec_d = routed(
                lambda: model.decode_step(params, cache, results.get("tok", tok), PROMPT), replay[1])
        results.setdefault("tok", tok)
        results[backend] = (logits.float(), tok, step_logits.float())
        recorded[backend] = (rec_p, rec_d)
    moe = bool(recorded["auto"][0])
    for i, what in enumerate(("prefill", "first decode step") if moe else ()):
        routing_gate(tag, what, [(used, own, z, src[2]) for (used, own, z), src
                                 in zip(recorded["reference"][i], recorded["auto"][i])], rel)
    label = " (the reference replaying auto's routing)" if moe else ""
    for i, what in ((0, "prefill logits"), (2, "first decode-step logits")):
        got, want = results["auto"][i], results["reference"][i]
        err, tol = float((got - want).abs().max()), rel * float(want.abs().max())
        say(f"[{tag}] {what}{label}: max abs err {err:.4e} (tol {tol:.4e} = {rel} x max |reference|)")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            fail(f"{what}: auto vs reference {err:.4e} > {tol:.4e}")
    # first generated tokens: equal, or the reference's top-2 margin is within the tolerance
    ref_logits = results["reference"][0]
    t_auto, t_ref = results["auto"][1][:, 0], results["reference"][1][:, 0]
    tol = rel * float(ref_logits.abs().max())
    margin = ref_logits.gather(1, t_ref[:, None]) - ref_logits.gather(1, t_auto[:, None])
    same = int((t_auto == t_ref).sum())
    say(f"[{tag}] first generated tokens agree {same}/{BATCH} (auto {t_auto.tolist()}, "
        f"reference {t_ref.tolist()})")
    if bool((margin[:, 0] > tol).any()):
        fail("first generated tokens differ by more than the logits tolerance")


# --------------------------------------------------------------------------- #
# where a decode step's time goes (after the gated phases; informational)
# --------------------------------------------------------------------------- #
def device_rows(prof, per: int = 1) -> list:
    """(device us, count, kernel name) of every device-side event of a
    ``torch.profiler`` trace, divided by ``per`` runs, largest first.  Only
    device events: a CPU op's row repeats its kernels' time."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / per, e.count // per, e.key))
    rows.sort(reverse=True)
    return rows


def device_busy_ms(prof, per: int = 1) -> float:
    """Device busy time of a ``torch.profiler`` trace in ms, divided by ``per``
    runs: the union of its device events' intervals.  Kernels may overlap
    (the skinny low-rank kernel is a programmatic dependent launch, resident
    while the kernel before it ends), so the sum of their times can exceed
    the time the device was busy."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        fail("the profiler trace holds no device event with a time range")
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3 / per


# the hand-written kernels' symbols, as the profiler names them
OWN_KERNELS = re.compile(r"\b(gemm_f32_kernel|gemm_kernel|expert_gemm_kernel|live_rows_kernel|skinny_kernel|"
                         r"flash_attention_kernel|flash_wgmma_kernel|decode::decode_kernel|ssd_scan_kernel|"
                         r"ssd_scan_fma_kernel)\b")
# the low-rank kernels' launches in a trace: the skinny decode kernel, the wgmma tiles of the
# 2-D kernel and of the sketch GEMM (one symbol), the expert stacks' tiles and liveness pass
SKINNY_KERNEL = re.compile(r"\bskinny_kernel\b")
TILE_KERNEL = re.compile(r"\bgemm_kernel\b")
EXPERT_KERNELS = re.compile(r"\b(expert_gemm_kernel|live_rows_kernel)\b")
FLASH_KERNELS = re.compile(r"\b(flash_attention_kernel|flash_wgmma_kernel)\b")


def phase_profile(model, params, batch, steps: int = 4):
    import torch
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
    rows = device_rows(prof, steps)
    device_ms = device_busy_ms(prof, steps) if rows else 0.0
    if not rows:
        say(f"[profile] q=4 decode step: wall {wall * 1e3:.3f} ms; device time not measured (no CUDA events)")
        return
    say(f"[profile] q=4 decode step (B={BATCH}, cache {PROMPT + GEN}): wall {wall * 1e3:.3f} ms (profiler off), "
        f"{wall_prof * 1e3:.3f} ms (profiler on); device busy {device_ms:.3f} ms (profiler); "
        f"idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f} of the profiler-off wall")
    for us, n, key in rows[:10]:
        say(f"[profile]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:90]}")


# --------------------------------------------------------------------------- #
# phase 7: the serving engine's main path at full width
# --------------------------------------------------------------------------- #
def engine_requests(cfg):
    """16 SyntheticLM prompts (seed 0) of 32-512 tokens, 16-64 new tokens each."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    lens[:2] = (PROMPT_RANGE[1], PROMPT_RANGE[0])  # the longest chunks, the shortest does not
    gens = rng.integers(GEN_RANGE[0], GEN_RANGE[1] + 1, size=N_REQUESTS)
    toks = SyntheticLM(cfg, batch=N_REQUESTS, seq=PROMPT_RANGE[1], kind="serve", seed=0).at_step(0)["tokens"]
    return [Request(prompt=toks[i, : lens[i]], max_new_tokens=int(gens[i])) for i in range(N_REQUESTS)]


def serve(model, params, label, *, libs, tag: str = "engine", **kw):
    """One engine run over the 16 requests, counts reset just before and read
    just after; returns (tokens per request, engine, launches, tok/s)."""
    import torch

    from repro_torch.runtime import dispatch
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.serving import Engine

    opts = dict(ENGINE)
    opts.update(kw)
    eng = Engine(model, params, **opts)
    reqs = engine_requests(model.cfg)
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    dispatch.reset_counters()
    ALIGN_COPIES.reset()
    t = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {n: lib.launches for n, lib in libs.items()}
    no_align_copies(f"the {tag} run ({label})")
    n_tok = sum(len(r.tokens) for r in reqs)
    bad = [r.uid for r in reqs if r.status != "ok" or len(r.tokens) != r.max_new_tokens
           or min(r.tokens) < 0 or max(r.tokens) >= model.cfg.vocab_padded]
    say(f"[{tag}] {label}: {len(reqs)} requests, {n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s; "
        f"steps {eng.steps}, host syncs {eng.host_syncs}, graph replays {eng.graph_replays}, "
        f"prefill chunks {eng.prefill_chunks}, peak active {eng.peak_active}, "
        f"peak pages {eng.peak_pages_in_use}/{eng.kv_pages}, kv bytes peak {eng.kv_bytes_peak} "
        f"of {eng.kv_bytes_capacity}; launches {launches}")
    if bad:
        fail(f"engine {label}: requests {bad} did not finish with their requested token counts")
    return [r.tokens for r in reqs], eng, launches, n_tok / dt


def no_align_copies(what: str) -> None:
    """Fail unless the TMA kernels' wrappers (sketch_matmul, lowrank_matmul,
    lowrank_matmul_batched) copied no operand into aligned rows since the
    shared count was last reset: the main path hands TMA its operands in
    place."""
    from repro_torch.kernels._build import ALIGN_COPIES

    if ALIGN_COPIES.count:
        fail(f"{what}: the TMA kernels' wrappers copied {ALIGN_COPIES.count} operands into aligned rows")


def engine_libs() -> dict:
    from repro_torch.kernels import decode_attention, flash_attention, lowrank_matmul, lowrank_matmul_batched
    from repro_torch.kernels import paged_decode_attention, sketch_matmul, ssd_scan

    return {"lowrank_matmul": lowrank_matmul.KERNEL, "sketch_matmul": sketch_matmul.KERNEL,
            "decode_attention": decode_attention.KERNEL, "flash_attention": flash_attention.KERNEL,
            "paged_decode_attention": paged_decode_attention.KERNEL,
            "lowrank_matmul_batched": lowrank_matmul_batched.KERNEL, "ssd_scan": ssd_scan.KERNEL}


def count_drops(model, seen) -> int:
    """Expert assignments that the routed calls ``seen`` (as ``routed``
    records them) drop past capacity, with the port's own moe_capacity."""
    import torch

    from repro_torch.models import moe as moe_mod

    E = model.cfg.n_experts
    return sum(int(torch.clamp(torch.bincount(ids.reshape(-1), minlength=E)
                               - moe_mod.moe_capacity(ids.shape[0], model.cfg), min=0).sum()) for ids, _, _ in seen)


def phase_engine(model, params, *, tag: str = "engine", on_path=("lowrank_matmul", "sketch_matmul",
                                                                    "flash_attention", "paged_decode_attention"),
                 dense_ok=frozenset()):
    """The engine's gates on ``model``.  ``dense_ok``: the (K, N) of linears
    the compression policy left dense (below min_dim), the only products
    allowed outside the low-rank kernels.  For the ssm and hybrid families
    also: every prefill micro-batch holds one prompt length, unpadded; the
    SSD kernel launched once per layer per prefill call; mamba2 (no paged
    leaf) reserved zero pages.  Their prefill is monolithic (the chunk is
    inert), so the chunked-vs-monolithic check is the attention families'."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.runtime import dispatch

    libs = engine_libs()
    main_tok, eng, launches, tps = serve(model, params, "paged + chunked, CUDA graph (main path)", libs=libs,
                                         tag=tag)
    say(f"[{tag}] dispatch table of the main run (calls that ran; graph calls counted per replay):")
    for line in dispatch.format_counters().splitlines():
        say(f"[{tag}]   {line}")
    missing = [n for n in on_path if launches[n] <= 0]
    if missing:
        fail(f"kernels never launched on the {tag} main path: {missing}")
    # every low-rank apply of the main run went through a kernel: no plain version, and no dense
    # product but those of linears the policy left dense
    plain = {k: n for k, n in dispatch.counters().items()
             if (k[0] == "dense" and tuple(k[2]) not in dense_ok)
             or (k[0] == "lowrank_matmul" and k[1] not in ("fused", "fused_batched"))}
    if plain:
        fail(f"the {tag} main path ran linears outside the kernels: {plain}")
    if eng.graph_replays <= 0:
        fail(f"the {tag} main path never replayed its decode graph")
    recurrent = model.cfg.family in ("ssm", "hybrid")
    if recurrent:
        mixed = [b for b in eng.prefill_batches if b[1] != b[2][0] or len(set(b[2])) != 1]
        say(f"[{tag}] prefill micro-batches (rows, length, prompt lengths): {eng.prefill_batches}")
        if mixed:
            fail(f"{tag}: prefill micro-batches mix or pad prompt lengths: {mixed}")
        want = model.cfg.n_layers * len(eng.prefill_batches)
        say(f"[{tag}] ssd_scan launches {launches['ssd_scan']} = {model.cfg.n_layers} layers x "
            f"{len(eng.prefill_batches)} prefill calls: {launches['ssd_scan'] == want}")
        if launches["ssd_scan"] != want:
            fail(f"{tag}: ssd_scan launched {launches['ssd_scan']} times, not once per layer per prefill ({want})")
        if model.cfg.family == "ssm":
            say(f"[{tag}] pages reserved at peak: {eng.peak_pages_in_use} (no cache leaf is paged)")
            if eng.peak_pages_in_use != 0:
                fail(f"{tag}: {eng.peak_pages_in_use} pages reserved, where no cache leaf is paged")
    eager_tok, *_ = serve(model, params, "paged + chunked, eager", libs=libs, tag=tag, cuda_graph=False)
    if eager_tok != main_tok:
        fail(f"{tag}: CUDA-graph tokens differ from the eager run's")
    say(f"[{tag}] CUDA-graph tokens == eager tokens: True")
    # A dense model's rows never meet, so its paged run may admit on half the
    # flat pool's pages (other micro-batches, other decode batches) and still
    # emit the flat run's tokens.  A moe layer's capacity drops depend on
    # which rows share a call, so there the paged pool gets the flat pool's
    # capacity, the two runs form the same micro-batches, and what differs
    # is only where the bytes live.
    moe = model.cfg.family == "moe"
    paged_tok, *_ = serve(model, params, "paged, no chunking" + (", flat-equal pool" if moe else ""), libs=libs,
                          tag=tag, prefill_chunk=None, **({"kv_pages": None} if moe else {}))
    flat_tok, _, flat_launches, _ = serve(model, params, "flat, no chunking", libs=libs, tag=tag, page_size=None,
                                          kv_pages=None, prefill_chunk=None)  # counts reset again inside
    if paged_tok != flat_tok:
        fail(f"{tag}: paged-engine tokens differ from the flat engine's")
    say(f"[{tag}] paged tokens == flat tokens: True")
    if model.cfg.family != "ssm" and flat_launches["decode_attention"] <= 0:
        fail(f"the {tag} flat run never launched decode_attention")
    if model.prefill_chunk is None:
        return {"tok_s": tps, "launches": launches, "launches_flat_engine": flat_launches,
                "prefill_batches": len(eng.prefill_batches)}

    # A chunked long prompt's first-token logits against the monolithic
    # prefill's.  Capacity changes results where it binds, and a monolithic
    # prefill sees more rows than a chunk, so the two compute the same
    # function only where no assignment drops.  A moe model's comparison
    # therefore runs the same params under a capacity that holds every token
    # (C >= T: capacity_factor = n_experts / top_k; at 1.25 the synthetic
    # router, which sends most tokens to a few experts, drops assignments
    # in every long prompt), so that it checks what it is for, the chunks'
    # attention through the pages.  The chunks attend with the plain
    # gather-and-einsum path and the monolithic prefill with the flash
    # kernel, so near-tied tokens may route apart (phase 10): the chunks
    # replay the monolithic prefill's routing, held to near ties by
    # ``routing_gate``.
    C, page, dev = ENGINE["prefill_chunk"], ENGINE["page_size"], model.device
    req = next(r for r in engine_requests(model.cfg) if r.prompt.size > C)
    L = int(req.prompt.size)
    toks = torch.as_tensor(req.prompt[None], dtype=torch.int64, device=dev)
    if moe:
        model = build_model(dataclasses.replace(model.cfg, capacity_factor=model.cfg.n_experts / model.cfg.top_k),
                            device=dev)
    (mono, _), mono_seen = routed(lambda: model.prefill(params, {"tokens": toks}, ENGINE["max_len"]))
    rel = 5e-2  # phase 5's tolerance: bf16 activations through every layer, one ulp apart at most places
    cache, _ = model.init_cache_paged(1, ENGINE["max_len"], page, ENGINE["kv_pages"])
    row = torch.arange(cache["block_table"].shape[1], dtype=torch.int32, device=dev)
    drops, pairs = count_drops(model, mono_seen), []
    for start in range(0, L, C):
        n = min(C, L - start)
        chunk = torch.zeros((1, C), dtype=torch.int64, device=dev)
        chunk[0, :n] = toks[0, start:start + n]
        replay = [used[start:start + n] for used, _, _ in mono_seen] if moe else None
        (chunked, _), seen = routed(lambda: model.prefill_chunk(params, cache, chunk, row, start, n), replay)
        drops += count_drops(model, seen)
        pairs += [(used[:n], own[:n], z[:n], src[2][start:start + n])
                  for (used, own, z), src in zip(seen, mono_seen)]
    label = ""
    if moe:
        say(f"[{tag}] chunked vs monolithic at capacity factor {model.cfg.capacity_factor} (C >= T): "
            f"{drops} expert assignments dropped in the monolithic prefill and the chunks")
        if drops:
            fail(f"{tag}: {drops} assignments dropped at capacity factor {model.cfg.capacity_factor}")
        routing_gate(tag, "chunked prefill (the monolithic prefill's routing replayed)", pairs, rel)
        label = ", the monolithic prefill's routing replayed"
    err, tol = float((chunked - mono).abs().max()), rel * float(mono.abs().max())
    say(f"[{tag}] chunked ({-(-L // C)} chunks of {C}{label}) vs monolithic "
        f"prefill of a {L}-token prompt: first-token logits max abs err {err:.4e} (tol {tol:.4e}); argmax "
        f"{int(chunked.argmax())} vs {int(mono.argmax())}")
    if not (err <= tol and bool(torch.isfinite(chunked).all())):
        fail(f"{tag}: chunked prefill logits {err:.4e} > {tol:.4e} from the monolithic prefill's")
    return {"tok_s": tps, "launches": launches, "launches_flat_engine": flat_launches}


# --------------------------------------------------------------------------- #
# phase 8: one captured decode block and one prefill chunk, profiled
# --------------------------------------------------------------------------- #
def phase_block_profile(model, params, blocks: int = 6, tag: str = "block"):
    """Host and device time of one captured decode block with every slot
    decoding; the trace of one block (one replay) must name the paged kernel.
    For a moe model, also the device time of the batched kernel's tiles."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lowrank_matmul as lowrank_mod
    from repro_torch.kernels import lowrank_matmul_batched as batched_mod
    from repro_torch.kernels import paged_decode_attention as paged_mod
    from repro_torch.kernels import sketch_matmul as sketch_mod
    from repro_torch.serving import Engine, Request

    eng = Engine(model, params, **ENGINE)
    rng = np.random.default_rng(1)
    # 64 + 256 tokens = 5 pages each, so all 8 requests fit the 40 pages at
    # once, and none finishes within the 2 + blocks + 1 blocks run here
    for _ in range(ENGINE["n_slots"]):
        eng.submit(Request(prompt=rng.integers(0, model.cfg.vocab, size=64), max_new_tokens=256))
    eng.step()  # admission, prefill, capture, the first block
    eng.step()
    if eng.n_active != ENGINE["n_slots"]:
        fail(f"the decode-block profile runs {eng.n_active} of {ENGINE['n_slots']} slots, not a full batch")
    torch.cuda.synchronize()
    tok0 = eng.decoded_tokens
    t = time.perf_counter()
    for _ in range(blocks):
        eng.step()
    wall = (time.perf_counter() - t) / blocks  # profiler off; each step ends in the block's drain
    tok_s = (eng.decoded_tokens - tok0) / (wall * blocks)
    libs = (paged_mod.KERNEL, lowrank_mod.KERNEL, sketch_mod.KERNEL, batched_mod.KERNEL)
    replays, before = eng.graph_replays, [lib.launches for lib in libs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()  # one block: the state copied in, one replay, the drain
    # wrapper calls in the replayed block (graph launches count once per replay)
    calls, lowrank_calls, sketch_calls, batched_calls = (lib.launches - b for lib, b in zip(libs, before))
    if eng.graph_replays != replays + 1:
        fail("the profiled engine step did not replay the decode graph exactly once")
    if eng.n_active != ENGINE["n_slots"]:
        fail(f"a slot finished inside the decode-block profile ({eng.n_active} of {ENGINE['n_slots']} active)")
    rows = device_rows(prof)
    names = " ".join(r[2] for r in rows)
    if "PagedRows" not in names:
        fail(f"the trace of one decode-block replay does not name the paged kernel: {names[:400]}")
    # one kernel launch a paged decode call: the trace's launches of kernels built on PagedRows
    # equal the wrapper's calls, and no second pass (combine) runs beside them
    paged_rows = [r for r in rows if "PagedRows" in r[2]]
    paged_launches, paged_ms = sum(r[1] for r in paged_rows), sum(r[0] for r in paged_rows) / 1e3
    say(f"[{tag}] paged decode: {calls} calls, {paged_launches} kernel launches in the trace "
        f"({', '.join(sorted({r[2][:60] for r in paged_rows}))}), {paged_ms:.4f} ms device")
    if calls <= 0 or paged_launches != calls or "combine_kernel" in names:
        fail(f"{tag}: {calls} paged decode calls ran {paged_launches} PagedRows kernel launches (one a call expected)")
    # the 2-D low-rank calls (decode: M = 8 slots, the skinny kernel): at most two launches a
    # call (one a stage), no reduce pass; the wgmma tiles' symbol is the sketch GEMM's too
    skinny = sum(r[1] for r in rows if SKINNY_KERNEL.search(r[2]))
    lowrank_launches = skinny + sum(r[1] for r in rows if TILE_KERNEL.search(r[2])) - sketch_calls
    lowrank_ms = sum(r[0] for r in rows if SKINNY_KERNEL.search(r[2])) / 1e3
    say(f"[{tag}] low-rank: {lowrank_calls} calls, {lowrank_launches} kernel launches in the trace ({skinny} of "
        f"the skinny kernel, {lowrank_ms:.4f} ms device); sketch GEMM calls {sketch_calls}")
    if lowrank_calls <= 0 or lowrank_launches > 2 * lowrank_calls or lowrank_launches <= 0:
        fail(f"{tag}: {lowrank_calls} low-rank calls ran {lowrank_launches} launches (at most two a call expected)")
    if "gemm_skinny_reduce_kernel" in names:
        fail(f"{tag}: the trace still holds a split-K reduce pass (gemm_skinny_reduce_kernel)")
    device_ms, kernel_ms = device_busy_ms(prof), sum(r[0] for r in rows) / 1e3
    say(f"[{tag}] one captured decode block ({ENGINE['decode_block']} steps x {eng.n_active} active slots): "
        f"host {wall * 1e3:.3f} ms per block (profiler off, copy in + replay + drain), device busy "
        f"{device_ms:.3f} ms (profiler, one block; its kernels' times sum to {kernel_ms:.3f} ms, overlap "
        f"counted twice); idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f}; "
        f"{eng.decoded_tokens - tok0} tokens decoded in the {blocks} timed blocks = {tok_s:.1f} tok/s")
    for us, n, key in rows[:12]:
        say(f"[{tag}]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:100]}")
    out = {"block_host_ms": wall * 1e3, "block_device_ms": device_ms, "block_kernel_sum_ms": kernel_ms,
           "idle_share": max(0.0, 1 - device_ms / (wall * 1e3)), "block_tok_s": tok_s,
           "block_paged_ms": paged_ms, "block_paged_launches": paged_launches,
           "block_lowrank_calls": lowrank_calls, "block_lowrank_launches": lowrank_launches,
           "block_lowrank_ms": lowrank_ms}
    if model.cfg.family == "moe":
        # the batched kernel's own symbols: its liveness pass and its expert-stack tiles
        tiles = [r for r in rows if EXPERT_KERNELS.search(r[2])]
        if not tiles or batched_calls <= 0:
            fail(f"{tag}: the trace names no launch of the batched kernel ({batched_calls} calls): {names[:400]}")
        out["batched_ms"] = sum(r[0] for r in tiles) / 1e3
        out["batched_launches"] = sum(r[1] for r in tiles)
        say(f"[{tag}] the batched kernel: {out['batched_ms']:.3f} ms of {device_ms:.3f} ms device "
            f"({out['batched_ms'] / device_ms:.3f}), {out['batched_launches']} launches over {batched_calls} calls "
            f"(a liveness pass and two stages a call)")
        if out["batched_launches"] != 3 * batched_calls:
            fail(f"{tag}: {batched_calls} batched calls ran {out['batched_launches']} launches (three a call)")
    return out


def phase_chunk_profile(model, params, calls: int = 5):
    """Host and device time of one chunked-prefill call at the main path's
    shape: the second (1, 256) chunk of a 512-token prompt, so its attention
    covers 512 positions.  Device time is split between the hand-written
    kernels and every other (torch) kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    C, page, dev = ENGINE["prefill_chunk"], ENGINE["page_size"], model.device
    cache, _ = model.init_cache_paged(ENGINE["n_slots"], ENGINE["max_len"], page, ENGINE["kv_pages"])
    row = torch.arange(cache["block_table"].shape[1], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(2)
    chunks = [torch.as_tensor(rng.integers(0, model.cfg.vocab, size=(1, C)), device=dev) for _ in range(2)]

    def run(n):  # host-clock seconds per chunk call, each as the engine makes it
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            model.prefill_chunk(params, cache, chunks[1], row, C, C)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n

    model.prefill_chunk(params, cache, chunks[0], row, 0, C)  # the prompt's first chunk
    run(1)  # warm-up
    wall = run(calls)  # profiler off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(1)
    rows = device_rows(prof)
    device_ms = device_busy_ms(prof)
    own_ms = sum(r[0] for r in rows if OWN_KERNELS.search(r[2])) / 1e3
    n_launch = sum(r[1] for r in rows)
    cpu_ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    say(f"[chunk] one prefill chunk (1, {C}) at position {C} of a {2 * C}-token prompt: host {wall * 1e3:.3f} ms "
        f"(profiler off, mean of {calls}); device busy {device_ms:.3f} ms (profiler): hand-written kernels "
        f"{own_ms:.3f} ms, other torch kernels {device_ms - own_ms:.3f} ms; {n_launch} device kernels, "
        f"{cpu_ops} aten ops; idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f}")
    for us, n, key in rows[:10]:
        say(f"[chunk]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:100]}")
    return {"chunk_host_ms": wall * 1e3, "chunk_device_ms": device_ms, "chunk_own_kernels_ms": own_ms}


# --------------------------------------------------------------------------- #
# phase 9: the MoE main path at full width
# --------------------------------------------------------------------------- #
def phase_moe_main():
    """phi3.5-moe at every published width and 4 of its 32 layers: random
    weights, spectralized, RSI-compressed at alpha 0.3 with q = 4; the q = 1
    run factorizes one expert matrix only, for the error gate."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.core.rsi import rsi_factors
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.models.model import analytic_param_count, build_model

    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    model = build_model(cfg)
    dev = model.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))  # the random init tree is freed here
    torch.cuda.synchronize()
    say(f"[moe] {MOE_ARCH} full width: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k}, expert d_ff {cfg.moe_d_ff}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}), untied lm_head, {cfg.dtype}; reduced: n_layers {full.n_layers} -> "
        f"{cfg.n_layers} (depth only: the dense model of all {full.n_layers} layers, "
        f"{analytic_param_count(full) * 2 / 1e9:.1f} GB in bf16, does not fit the card before compression); "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params; init + spectralize {time.perf_counter() - t0:.1f}s")
    W = dense["layers"]["moe"]["experts"]["w_gate"][0, 0].clone()
    t = time.perf_counter()
    ALIGN_COPIES.reset()
    params, rep = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    no_align_copies(f"{MOE_ARCH} compression")
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t
    del dense
    torch.cuda.empty_cache()
    ranks = sorted({l.rank for l in rep.layers if l.compressed})
    by_path = {l.path: l.compressed for l in rep.layers}
    want = {"layers/moe/experts/w_gate": True, "layers/moe/experts/w_up": True, "layers/moe/experts/w_down": True,
            "layers/attn/wq": True, "layers/attn/wk": True, "lm_head": True, "layers/moe/router/gate_w": False,
            "embed": False}
    wrong = {p: by_path.get(p) for p, c in want.items() if by_path.get(p) != c}
    if wrong:
        fail(f"moe compression decisions differ from the reference's: {wrong}")
    say(f"[moe] compress q=4: {rep.summary()} ranks {ranks} in {comp_s:.1f}s")

    gate = params["layers"]["moe"]["experts"]["w_gate"]
    k = gate["a"].shape[-1]
    sv = torch.linalg.svdvals(W.float())
    errs = {4: float(normalized_error_factored(W, gate["a"][0, 0], gate["b"][0, 0], sv[k], gen(2), iters=64))}
    t = time.perf_counter()
    A1, B1 = rsi_factors(W, k, 1, generator=gen(3))
    torch.cuda.synchronize()
    q1_s = time.perf_counter() - t
    errs[1] = float(normalized_error_factored(W, A1, B1, sv[k], gen(2), iters=64))
    peak = torch.cuda.max_memory_allocated()
    say(f"[moe] layer 0 expert 0 w_gate (4096x6400, k={k}) normalized error ||W-AB||_2/s_(k+1): q=4 {errs[4]:.4f}, "
        f"q=1 {errs[1]:.4f} (that one matrix in {q1_s:.2f}s)")
    say(f"[moe] peak device memory {peak / 2**30:.2f} GiB (max_memory_allocated, init to compressed model) on "
        f"{card_line()}")
    if not errs[4] <= errs[1]:
        fail(f"moe: q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    toks = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    summary = {"n_layers": cfg.n_layers, "ratio": rep.ratio, "ranks": ranks, "compress_s": comp_s,
               "normalized_error": errs, "peak_gib": peak / 2**30}
    return model, params, batch, summary


# --------------------------------------------------------------------------- #
# phase 2 (SSM): the SSD scan kernel, and attention at G = 1
# --------------------------------------------------------------------------- #
def ssd_ops(B: int, L: int, nh: int, hd: int, s: int, Q: int = SSD_CHUNK) -> int:
    """Operations of the chunked SSD at chunk Q on these shapes, counting each
    product once: C B^T once per (sequence, chunk), shared by the heads; the
    masked intra-chunk product over its t >= u half; the carried state's
    contribution to y; the state update."""
    n_chunks = -(-L // Q)
    per_chunk = 2 * Q * Q * s + nh * (Q * (Q + 1) * hd + 2 * Q * s * hd + 2 * Q * s * hd)
    return B * n_chunks * per_chunk


def phase_ssd_kernels(rnd, gen, records) -> None:
    """``ssd_scan`` against its plain version (the reference's chunk rule) at
    zamba2-1.2b's shapes (nh 64, hd 64, s 64) at (B, L) = (1, 512) and
    (4, 256), and mamba2-130m's (nh 24, hd 64, s 128) at 512, a prime 509
    (where the plain version's chunk falls to 1) and 40 (shorter than one
    kernel chunk); under both x̄ contracts, in bf16 and fp32; y and the final
    state, each case timed beside its bound and its plain version's time.
    At the main-path shape (the first case) a second call must return the
    same bits (a fixed summation order, no atomics).  Each bf16 case is
    kept in ``records`` under its shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    dev = torch.device("cuda")
    # (B, L, nh, hd, s, round_xbar): the model's contract (x̄ rounded) first, the main path's shape
    cases = [(1, 512, 64, 64, 64, True), (1, 512, 64, 64, 64, False), (4, 256, 64, 64, 64, True),
             (1, 512, 24, 64, 128, True), (1, 509, 24, 64, 128, True), (2, 40, 24, 64, 128, False)]
    state_tol = (1e-4, "the fp32 state: the kernel's 64-step chunks against the reference's chunk rule "
                 "change the summation order only; x̄ is the same one multiply on both sides")
    ssd_tol = {torch.bfloat16: (1e-2, "bf16 y may land one ulp (2^-8) apart where fp32 sums in another order "
                                "(chunk boundaries, the within-chunk cumulative sum) straddle a rounding boundary"),
               torch.float32: (1e-4, "fp32 sums in another order: chunk boundaries and the within-chunk "
                               "cumulative sum")}
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = ssd_tol[dtype]
        for Bq, L, nh, hd, s, rnd_x in cases:
            x = rnd((Bq, L, nh, hd), dtype, scale=1.0)
            dt = F.softplus(torch.randn((Bq, L, nh), generator=gen, device=dev))
            Bm, Cm = rnd((Bq, L, s), dtype, scale=s**0.5), rnd((Bq, L, s), dtype, scale=s**0.5)
            A = -torch.linspace(1.0, 16.0, nh, device=dev)  # -exp(A_log) of the model's init
            y, st = ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=rnd_x)
            want_y, want_s = ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=256, round_xbar=rnd_x)
            contract = "x̄ rounded" if rnd_x else "x̄ fp32"
            if (Bq, L, nh, hd, s, rnd_x) == cases[0]:
                y2, st2 = ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=rnd_x)
                same = bool(torch.equal(y, y2)) and bool(torch.equal(st, st2))
                say(f"[ssd kernels] a second call at {list(cases[0])} {dtype} returns the same bits: {same}")
                if not same:
                    fail(f"ssd_scan {list(cases[0])} {dtype}: two calls on the same inputs differ")
                del y2, st2
            key = f"ssd_scan {Bq}x{L} nh {nh} s {s} {contract}"
            check("ssd_scan", [Bq, L, nh, hd, s, contract], dtype, y, want_y, rel, why,
                  kernel_fn=lambda: ssd_scan(x, dt, Bm, Cm, A, chunk=256, round_xbar=rnd_x),
                  plain_fn=lambda: ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk=256, round_xbar=rnd_x),
                  library_fn=None,  # no single PyTorch call computes the SSD scan
                  bytes_moved=nbytes(x, dt, Bm, Cm, A, y, st), ops=ssd_ops(Bq, L, nh, hd, s),
                  records=records if dtype == torch.bfloat16 else {}, key=key)
            if dtype == torch.bfloat16 and "ssd_scan" not in records:
                records["ssd_scan"] = records[key]
            err, tol = float((st - want_s).abs().max()), state_tol[0] * float(want_s.abs().max())
            say(json.dumps({"name": "ssd_scan final state", "shape": [Bq, L, nh, hd, s, contract],
                            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol,
                            "tol_reason": state_tol[1], "ok": err <= tol}))
            if not (err <= tol and bool(torch.isfinite(st).all())):
                fail(f"ssd_scan final state {[Bq, L, nh, hd, s, contract]} {dtype}: {err:.3e} > {tol:.3e}")
            del x, dt, Bm, Cm, y, st, want_y, want_s
    torch.cuda.empty_cache()


def phase_ssm_kernels(rnd, gen, records) -> dict:
    """The SSD scan's cases (:func:`phase_ssd_kernels`), then the three
    attention kernels at zamba2's shared block, G = 1 (32/32 heads,
    head_dim 64).  Returns {kernel: bf16 record} at G = 1."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention

    dev = torch.device("cuda")
    phase_ssd_kernels(rnd, gen, records)
    attn_tol = {torch.bfloat16: (2e-2, "bf16: p is rounded before PV and the output is rounded"),
                torch.float32: (1e-4, "fp32 online softmax vs one-pass softmax, another summation order")}
    g1: dict = {}
    H = KV = 32
    hd, Bq, S, page = 64, ENGINE["n_slots"], ENGINE["max_len"], ENGINE["page_size"]
    n_tbl = -(-S // page)
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        q, k, v = (rnd((BATCH, PROMPT, H, hd), dtype) for _ in range(3))
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        check("flash_attention", [BATCH, PROMPT, H, KV, hd, None], dtype, flash_attention(q, k, v, causal=True),
              ref.chunked_attention_ref(q, k, v, causal=True), rel, why,
              kernel_fn=lambda: flash_attention(q, k, v, causal=True),
              plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True),
              bytes_moved=nbytes(q, k, v) + q.numel() * q.element_size(),
              ops=4 * BATCH * H * (PROMPT * (PROMPT + 1) // 2) * hd, records=g1)
        q, k, v = rnd((Bq, 1, H, hd), dtype), rnd((Bq, S, KV, hd), dtype), rnd((Bq, S, KV, hd), dtype)
        n_valid = torch.tensor([S, 1, 0, 65, 191, 100, S // 2, 7], device=dev)
        valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
        mask, n_rows = valid[:, None, None, :], int(valid.sum())
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        check("decode_attention", [Bq, S, H, KV, hd, "ragged mask"], dtype, decode_attention(q, k, v, valid),
              ref.decode_attention_ref(q, k, v, valid), rel, why,
              kernel_fn=lambda: decode_attention(q, k, v, valid),
              plain_fn=lambda: ref.decode_attention_ref(q, k, v, valid),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
              bytes_moved=nbytes(q, valid) + n_rows * KV * 2 * hd * k.element_size() + Bq * H * hd * q.element_size(),
              ops=4 * H * hd * n_rows, records=g1)
        P = Bq * n_tbl + 1
        kp, vp = rnd((P, page, KV, hd), dtype), rnd((P, page, KV, hd), dtype)
        kp[-1], vp[-1] = 1e4, -1e4
        bt = torch.randperm(P - 1, generator=gen, device=dev)[: Bq * n_tbl].reshape(Bq, n_tbl).to(torch.int32)
        nv = n_valid.to(torch.int32)
        got = paged_decode_attention(q, kp, vp, bt, nv)
        if not bool(torch.equal(got, decode_attention(q, ref.gather_pages(kp, bt), ref.gather_pages(vp, bt), valid))):
            fail(f"paged_decode_attention at page 64, G = 1 ({dtype}) differs from the flat kernel")
        say(f"[ssm kernels] paged == flat kernel bit for bit at page 64, 32/32 heads, head_dim 64, {dtype}: True")
        ks, vs = ref.gather_pages(kp, bt).transpose(1, 2), ref.gather_pages(vp, bt).transpose(1, 2)
        check("paged_decode_attention", [Bq, page, n_tbl, H, KV, hd, "ragged n_valid"], dtype, got,
              ref.paged_decode_attention_ref(q, kp, vp, bt, nv), rel, why,
              kernel_fn=lambda: paged_decode_attention(q, kp, vp, bt, nv),
              plain_fn=lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, nv),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
              bytes_moved=nbytes(q, bt, nv) + n_rows * KV * 2 * hd * kp.element_size() + Bq * H * hd * q.element_size(),
              ops=4 * H * hd * n_rows, records=g1)
        del q, k, v, kp, vp, got
    torch.cuda.empty_cache()
    return g1


# --------------------------------------------------------------------------- #
# phases 13-17: the SSM main paths
# --------------------------------------------------------------------------- #
# the compression decisions the reference's policy makes at min_dim 32 (its
# exclude skips conv, dt_*, A_log, D_param and the norms; w_dt is compressed
# where its narrow side reaches min_dim: the ``dt_`` pattern matches a path
# segment that STARTS with dt_); mamba2's w_dt (768 x 24) is under min_dim
SSM_DECISIONS = {
    "zamba2-1.2b": {"layers/mamba/w_z": True, "layers/mamba/w_x": True, "layers/mamba/w_B": True,
                    "layers/mamba/w_C": True, "layers/mamba/w_dt": True, "layers/mamba/out_proj": True,
                    "layers/mamba/conv_x": False, "layers/mamba/A_log": False, "layers/mamba/dt_bias": False,
                    "layers/mamba/D_param": False, "layers/mamba/ssm_norm/scale": False,
                    "layers/ssm_in_norm/scale": False, "shared_attn/attn/wq": True,
                    "shared_attn/mlp/w_gate": True, "lm_head": True, "embed": False},
    "mamba2-130m": {"layers/mamba/w_z": True, "layers/mamba/w_x": True, "layers/mamba/w_B": True,
                    "layers/mamba/w_C": True, "layers/mamba/w_dt": False, "layers/mamba/out_proj": True,
                    "layers/mamba/conv_x": False, "embed": False},
}


def phase_ssm_main(arch: str):
    """An SSM arch at full width and depth: random weights (seed 0),
    spectralized (seed 9), RSI-compressed at alpha 0.3, q = 4, min_dim 32.
    Gate: on layer 0's w_x, q = 4's normalized error <= q = 1's (the q = 1
    run factorizes that one matrix); the compression decisions are the
    reference's.  Returns (model, params, batch, summary, dense_ok)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.core.rsi import rsi_factors
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.models.model import analytic_param_count, build_model

    cfg = get_arch(arch)
    model = build_model(cfg)
    dev, tag = model.device, arch.split("-")[0]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))
    torch.cuda.synchronize()
    shared = (f", one shared attention+MLP block ({cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
              f"d_ff {cfg.d_ff}) after every {cfg.attn_every} layers") if cfg.family == "hybrid" else ""
    say(f"[{tag}] {arch} full width and depth: {cfg.n_layers} Mamba2 layers, d {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.n_ssm_heads} SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}{shared}; vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}), {'tied' if cfg.tie_embeddings else 'untied'} head, {cfg.dtype}; "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params; init + spectralize {time.perf_counter() - t0:.1f}s")
    W = dense["layers"]["mamba"]["w_x"][0].clone()
    t = time.perf_counter()
    ALIGN_COPIES.reset()
    params, rep = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    no_align_copies(f"{arch} compression")
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t
    del dense
    torch.cuda.empty_cache()
    ranks = sorted({l.rank for l in rep.layers if l.compressed})
    by_path = {l.path: l.compressed for l in rep.layers}
    wrong = {p: by_path.get(p) for p, c in SSM_DECISIONS[arch].items() if by_path.get(p) != c}
    if wrong:
        fail(f"{arch} compression decisions differ from the reference's: {wrong}")
    dense_ok = frozenset(l.shape[-2:] for l in rep.layers if not l.compressed and l.reason.startswith("min-dim"))
    say(f"[{tag}] compress q=4: {rep.summary()} ranks {ranks} in {comp_s:.1f}s; left dense below min_dim: "
        f"{sorted(dense_ok)}")
    ax = params["layers"]["mamba"]["w_x"]
    k = ax["a"].shape[-1]
    sv = torch.linalg.svdvals(W.float())
    errs = {4: float(normalized_error_factored(W, ax["a"][0], ax["b"][0], sv[k], gen(2), iters=64))}
    A1, B1 = rsi_factors(W, k, 1, generator=gen(3))
    errs[1] = float(normalized_error_factored(W, A1, B1, sv[k], gen(2), iters=64))
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] layer 0 w_x ({W.shape[0]}x{W.shape[1]}, k={k}) normalized error ||W-AB||_2/s_(k+1): "
        f"q=4 {errs[4]:.4f}, q=1 {errs[1]:.4f}")
    say(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB (max_memory_allocated, init to compressed model) on "
        f"{card_line()}")
    if not errs[4] <= errs[1]:
        fail(f"{arch}: q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    toks = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    summary = {"ratio": rep.ratio, "ranks": ranks, "compress_s": comp_s, "normalized_error": errs,
               "peak_gib": peak / 2**30}
    return model, params, batch, summary, dense_ok


def phase_prefill_profile(model, params, L: int = 512, calls: int = 3, tag: str = "zamba2 prefill"):
    """Host and device time of one monolithic (1, L) prefill, as the engine
    makes it for one prompt, and the SSD kernel's share of the device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan

    toks = torch.as_tensor(np.random.default_rng(3).integers(0, model.cfg.vocab, size=(1, L)), device=model.device)
    last = torch.tensor([L - 1], device=model.device)

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            model.prefill(params, {"tokens": toks}, ENGINE["max_len"], last_index=last)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n

    run(1)  # warm-up
    wall = run(calls)  # profiler off
    before = ssd_scan.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(1)
    if ssd_scan.KERNEL.launches - before != model.cfg.n_layers:
        fail(f"{tag}: one prefill launched ssd_scan {ssd_scan.KERNEL.launches - before} times, "
             f"not once per layer ({model.cfg.n_layers})")
    rows = device_rows(prof)
    device_ms = device_busy_ms(prof)
    ssd_ms = sum(r[0] for r in rows if "ssd_scan_kernel" in r[2]) / 1e3
    flash_ms = sum(r[0] for r in rows if FLASH_KERNELS.search(r[2])) / 1e3
    own_ms = sum(r[0] for r in rows if OWN_KERNELS.search(r[2])) / 1e3
    # one scan call's bound at this shape: x, dt, B, C, A read once, y and the fp32 state written once
    cfg = model.cfg
    nh, hd, s = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ssd_bytes = 2 * L * nh * hd * 2 + L * nh * 4 + 2 * L * s * 2 + nh * 4 + nh * hd * s * 4
    ssd_bound, ssd_by = bound(ssd_bytes, ssd_ops(1, L, nh, hd, s), "bfloat16")
    say(f"[{tag}] one monolithic (1, {L}) prefill: host {wall * 1e3:.3f} ms (profiler off, mean of {calls}); "
        f"device busy {device_ms:.3f} ms (profiler): ssd_scan {ssd_ms:.3f} ms ({ssd_ms / device_ms:.3f}, "
        f"{cfg.n_layers} launches, {ssd_ms / cfg.n_layers:.4f} ms a launch against a bound of {ssd_bound:.4f} ms "
        f"({ssd_by})), flash_attention {flash_ms:.3f} ms ({flash_ms / device_ms:.4f}), all "
        f"hand-written kernels {own_ms:.3f} ms; idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f}")
    for us, n, key in rows[:10]:
        say(f"[{tag}]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:100]}")
    return {"prefill_host_ms": wall * 1e3, "prefill_device_ms": device_ms, "prefill_ssd_ms": ssd_ms,
            "prefill_ssd_share": ssd_ms / device_ms, "prefill_ssd_launches": cfg.n_layers,
            "prefill_ssd_bound_ms": ssd_bound, "prefill_flash_ms": flash_ms,
            "prefill_flash_share": flash_ms / device_ms}



def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if "--lowrank-only" in sys.argv:
        return phase_lowrank_only()
    if "--ssd-only" in sys.argv:
        return phase_ssd_only()
    if "--prefill-only" in sys.argv:
        return phase_prefill_only()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    import gc

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
            say(f"[ptxas {name}] {ptxas_summary(log.read_text())}")
    for name, opcodes in REDESIGNED.items():
        for opcode in opcodes:
            n = sass_count(built[name], opcode)
            say(f"[sass {name}] " + ("cuobjdump not found" if n is None else f"{opcode} instructions: {n}"))
            if n == 0:
                fail(f"{name}: no {opcode} instruction in the built library")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    t = time.perf_counter()
    records, phi, g1 = phase_kernels()
    say(f"[kernels] all checks within tolerance in {time.perf_counter() - t:.1f}s")
    runs = {}  # launches per kernel on each main run, counts reset just before it
    model, params_q4, batch, runs["llama3.2-1b static"] = phase_main()
    phase_reference(model, params_q4, batch)
    phase_profile(model, params_q4, batch)
    engine = phase_engine(model, params_q4)
    runs["llama3.2-1b engine"], runs["llama3.2-1b flat engine"] = engine["launches"], engine["launches_flat_engine"]
    block = phase_block_profile(model, params_q4)
    chunk = phase_chunk_profile(model, params_q4)
    say("[engine] " + json.dumps({"tok_s": engine["tok_s"], **block, **chunk}))
    del model, params_q4, batch  # the llama phases' model, before the MoE phases
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    moe_model, moe_params, moe_batch, moe = phase_moe_main()
    phase_reference(moe_model, moe_params, moe_batch, tag="moe reference")
    moe_engine = phase_engine(moe_model, moe_params, tag="moe engine",
                              on_path=("lowrank_matmul_batched", "lowrank_matmul", "flash_attention",
                                       "paged_decode_attention"))
    runs["phi3.5-moe engine"], runs["phi3.5-moe flat engine"] = moe_engine["launches"], moe_engine["launches_flat_engine"]
    moe_block = phase_block_profile(moe_model, moe_params, tag="moe block")
    say("[moe engine] " + json.dumps({"tok_s": moe_engine["tok_s"], **moe_block, **moe,
                                      "moe_phases_s": time.perf_counter() - t}))
    del moe_model, moe_params, moe_batch
    gc.collect()
    torch.cuda.empty_cache()

    # the SSM slice: zamba2-1.2b (the main path: every prefill through ssd_scan, the shared
    # block through the attention kernels at G = 1), then mamba2-130m
    for arch in SSM_ARCHS:
        t = time.perf_counter()
        tag = arch.split("-")[0]
        model, params, batch, summary, dense_ok = phase_ssm_main(arch)
        summary["branch_err_ratio"] = phase_blocks_reference(model, params, batch, tag=f"{tag} reference")
        summary["reference"] = phase_ssm_reference(model, params, batch, tag=f"{tag} reference")
        on_path = ("ssd_scan", "lowrank_matmul") + (("flash_attention", "paged_decode_attention")
                                                    if model.cfg.family == "hybrid" else ("sketch_matmul",))
        eng = phase_engine(model, params, tag=f"{tag} engine", on_path=on_path, dense_ok=dense_ok)
        runs[f"{arch} engine"], runs[f"{arch} flat engine"] = eng["launches"], eng["launches_flat_engine"]
        prof = phase_prefill_profile(model, params, tag=f"{tag} prefill")
        if model.cfg.family == "hybrid":
            prof.update(phase_block_profile(model, params, tag=f"{tag} block"))
        say(f"[{tag} engine] " + json.dumps({"tok_s": eng["tok_s"], "prefill_batches": eng["prefill_batches"],
                                             **prof, **summary, "phases_s": time.perf_counter() - t}))
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()

    # `launches`: the kernel's count on the main run of the newest path that runs it
    newest_first = ["zamba2-1.2b engine", "mamba2-130m engine", "zamba2-1.2b flat engine", "phi3.5-moe engine",
                    "llama3.2-1b engine", "llama3.2-1b flat engine"]
    line = []
    for name in KERNELS:
        r = records[name]
        run = next((k for k in newest_first if runs[k].get(name, 0) > 0), "llama3.2-1b static")
        entry = {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                 "replaces": REPLACES[name], "launches": runs[run].get(name, 0), "launches_run": run,
                 "launches_by_run": {k: v.get(name, 0) for k, v in runs.items()},
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"], "dtype": r["dtype"]}
        # the attention kernels at phi's head_dim 128 and zamba2's G = 1; the sketch GEMM's
        # W^T @ X, tied logits and untied head; the low-rank kernel's w_gate at M 8, 256 and
        # 1024; the batched kernel at the decode and the skewed occupancy
        subs = (("hd128", phi, name), ("g1", g1, name), ("trans_a", records, f"{name} trans_a"),
                ("logits", records, f"{name} logits"), ("untied_head", records, f"{name} untied head"),
                ("m8", records, f"{name} M 8"), ("m256", records, f"{name} M 256"),
                ("m1024", records, f"{name} M 1024"), ("decode_occupancy", records, f"{name} decode"),
                ("skewed_occupancy", records, f"{name} skewed"),
                ("zamba2_4x256", records, f"{name} 4x256 nh 64 s 64 x̄ rounded"),
                ("mamba2_1x512", records, f"{name} 1x512 nh 24 s 128 x̄ rounded"))
        for key, sub, rec_key in subs:
            if rec_key in sub:
                entry[key] = {k: sub[rec_key][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}
        line.append(entry)
    say(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
    say("[earlier] times of the redesigned kernels before this round, copied from PERF.md section 6 "
        "(not measured in this run): " + json.dumps(EARLIER_MS))
    say(json.dumps({"kernels": line}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
