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
    python3 chip_smoke.py --paper-only
                             # phase 18 (the paper's experiments) alone
    python3 chip_smoke.py --sharing-only
                             # phases 19-20 (the dense archs, prefix sharing) alone
    python3 chip_smoke.py --overload-only
                             # phase 21 (engine stage 4) alone, on the q = 4 llama3.2-1b
    python3 chip_smoke.py --chunk-only [--src DIR]
                             # each dense model's profiled (1, 256) prefill chunk, on DIR
    python3 chip_smoke.py --h2o-only
                             # phase 2's h2o-danube checks and phase 22 (the sliding-window
                             # ring) alone
    python3 chip_smoke.py --deepseek-only
                             # phase 2's deepseek-v2 checks and phase 23 (MLA) alone
    python3 chip_smoke.py --vlm-only
                             # phase 2's non-causal flash checks and phase 24
                             # (llama-3.2-vision-11b) alone
    python3 chip_smoke.py --whisper-only
                             # phase 2's non-causal flash checks and phase 25
                             # (whisper-small) alone
    python3 chip_smoke.py --cluster-only
                             # phases 26-27 (the replicated cluster, the examples and
                             # kernels/ops.py) alone, on the q = 4 llama3.2-1b
    python3 chip_smoke.py --train-only
                             # phase 2's training cases and phase 28 (training) alone,
                             # on the q = 4 llama3.2-1b, then mamba2-130m
    python3 chip_smoke.py --multi-only
                             # phase 29 (the multi-device layer on eight ranks sharing
                             # the card, the tensor-parallel program in (f)) alone,
                             # on the q = 4 llama3.2-1b
    python3 chip_smoke.py --dryrun-only
                             # phase 30 (the dry-run's counts against the card) alone

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
   at M 8 on phi3.5-moe's untied head and zamba2's w_x, and on the
   w_gate of llama3.2-1b, minitron-4b and qwen2-72b at the prefill M 16,
   64, 256 and 1024 (``[prefill plan]``: the batch-invariant plan's cost).  The
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
   At phases 19-20's shapes: the three attention kernels at minitron-4b's
   24/8 heads (G = 3) and qwen2-72b's 64/8 (G = 8), head_dim 128;
   lowrank_matmul at minitron's w_gate (3072 x 922 x 9216) at M 4, 8 and 64
   and qwen2's (8192 x 2458 x 29568) at M 4 and 8; the sketch GEMM at
   qwen2's w_gate, W @ Y and W^T @ X.  At phase 22's shapes (h2o-danube:
   32/8 heads, head_dim 80, window 4096): flash_attention at (4, 256),
   the window out of reach, and at (1, 16384), its bound counting the
   in-window pairs only and its library call SDPA under the window mask
   (bf16); decode_attention over a wrapped ring of 4096 slots, 8 rows,
   every slot valid; lowrank_matmul at the w_gate (2560 x 768 x 6912) at M
   4 and 8.  At phase 23's shapes (deepseek-v2: 128/128 heads, MLA's q/k
   head dim 192 with v 128; 160 experts top-6 at rank 461): flash_attention
   at (4, 256), causal, and a chunk of 70 queries at q_offset 186 over 256
   keys (the library call SDPA at E 192 / Ev 128 where a backend takes it);
   the batched low-rank kernel on one layer's w_gate and w_down stacks (160
   x C 128) with every row live, then at the decode occupancy (8 tokens x
   top-6, numpy seed 0); lowrank_matmul at wo (16384 x 1536 x 5120) and
   wq_b (1536 x 461 x 24576) at M 4 and 8; the sketch GEMM at one expert's
   w_gate (5120 x 1536, l 461), W @ Y and W^T @ X.  At phases 24-25's
   shapes (NONCAUSAL_FLASH, G = 1): flash_attention non-causal over
   whisper's 1500 frames (its encoder at (4, 1500); cross-attention at
   (4, 256) and at one query, (8, 1)), over vision's 1600 image tokens
   (32 heads at hd 128: (4, 256) and (8, 1)), over one key and over 65,
   its library call SDPA without a mask; at one query the decode kernel's
   time on the same keys beside it (a comparison); each one-query shape
   captured in a CUDA graph and replayed on new queries, equal to the
   eager launch bit for bit.  Phase 1 also prints each
   flash instance's registers and spills, (192, 128) among them.
   The training cases (``[grad]`` lines), bf16 then fp32: each autograd
   Function of ``runtime/dispatch.py`` (the kernel forward, the plain
   backward) against autograd through the plain version on the same inputs
   and cotangent, every output and gradient within 3e-2 (bf16) or 1e-4
   (fp32) of its largest value and every gradient nonzero: the low-rank
   Function at llama's w_gate over 2048 rows and at phi3.5-moe's expert
   stack (16 x 128, rank 1229), the flash Function causal at (8, 256) G 4,
   windowed (hd 80, window 128), non-causal (G 1) and MLA's 192 / 128, the
   logits Function tied (llama's 128256 x 2048 table, 128 rows) and untied
   (phi's head), the SSD Function at mamba2-130m's (8, 64); each with the
   kernel forward's time, the Function backward's and the plain forward +
   backward's.  The flash kernel's lse within 1e-3 (bf16; fp32 1e-4) of
   the plain forward's, and its output the same bits with and without it.
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
   engine's tokens on half the flat pool's pages (other micro-batches: a
   prompt row's bits do not depend on its call's M) equal a flat engine's
   (no chunking; a moe model at the flat pool's capacity); a chunked long
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
18. The paper on the card, fp32, through ``repro_torch.experiments`` and
   ``launch/compress.py`` with the kernels (backend auto).  First phase 2's
   checks at this phase's shapes: the sketch GEMM on Fig 4.1's W (k 50 and
   200, both orientations) and the low-rank kernel on Table 4.1's fc1.
   Fig 4.1 at the paper's 4096 x 25088 (k 50/100/200, q 1-4, 3 trials):
   gates err(q=4) < err(q=1) at every k, every error >= 0.99, sketch_matmul
   launched 2q times per RSI call, and at (200, 4) from one Omega the error
   under auto within 1e-3 (relative) of reference; one RSI call at (50, 1),
   (50, 4) and (200, 4) profiled (the sketch kernel's share of the device
   time).  Fig 4.2 (768 x 3072, k 100/300/500): the exact SVD's seconds,
   each RSI's and the speedup, the same gates.  Table 4.1's whole grid:
   the ratios equal the reference's (1.461, 1.101, 0.739, 0.380); at alpha
   0.2 top-1(q=4) - top-1(q=1) >= 0.05 and top-1(q=4) >= baseline - 0.03;
   lowrank_matmul launched on the compressed forwards.  Theorem 3.2: the
   trained head (W = fc2^T, 10 x 512) at rank 4 (q 1 and 4; and ranks 8 and
   9 at q 4): the certificate's ||W - W~||_2 within 1e-3 (relative) of the
   exact norm s1 where the residual's (s2/s1)^64 <= 1e-4 (at least one rank
   must be), else in [s2 (1 - 1e-2), s1 (1 + 1e-4)]; its measured largest
   class-probability deviation over the test set <= the certificate's
   bound + 1e-4, on the features as they are and scaled so that the bound
   is 0.25; ``certify_tier`` on llama3.2-1b's w_gate
   stack (compressed as in phase 3) at half its rank within 2% of max over
   layers ||A[:, r']|| ||B[r', :]||.  The compression CLI on full-width
   llama3.2-1b with ``--rank-rule alpha --errors`` and ``--rank-rule energy
   --errors``: every compressed rank under break-even, every error finite.
19. minitron-4b at full width with n_layers cut 32 -> 16 (the whole
   script's time: its eager sharing runs scale with depth; d 3072, 24/8 heads:
   G = 3, head_dim 128, d_ff 9216, untied 256000-word head; bf16), random
   weights (seed 0), spectralized (seed 9), compressed at alpha 0.3, q = 4
   (RSI's sketch GEMMs launched during compression); gates: the reference's
   compression decisions, q = 4's normalized error <= q = 1's on layer 0's
   w_gate; auto vs reference three ways, as phase 14 (every prefill branch
   teacher-forced in bf16 within 5%, fp32 end to end within 1e-2, bf16 end
   to end within 1.2 x the reference's own bf16 error against its fp32 run
   fed the same token: through 32 layers of random spectralized weights
   each bf16 run lay ~8% of max |logit| from the fp32 one, so phase 5's 5%
   between two bf16 runs is printed, not gated); phase 7's engine gates
   (graph == eager, paged on half the flat pool == flat, every kernel of
   the path launched) and its profiled (1, 256) prefill chunk.  Then the
   sharing runs, two engines differing only in ``share_prefix`` (page 64,
   8 slots, 40 pages, prefill chunk 64 = the page, every prompt longer than
   one chunk): shared == unshared greedy tokens bit for bit is a gate in
   each.  (a) 16 requests at once, a 128-token system prompt, a 16-384-token
   suffix and 16-64 new tokens each (gate: pages shared); (b) three
   followers whose whole prompt is the 128 indexed tokens (gate: cow_forks
   >= 1); (c) the session cache: turn 2 extends turn 1's prompt and reply
   and must match pages past turn 1's prompt, then drop_session frees > 0
   cached pages; (d) warm_cache_pages 4 in a 16-page pool (gate:
   prefix_evictions > 0); and (a) again at the engine's usual chunk of 256,
   reported without a bitwise gate (tokens equal, or the first differing
   request's first-token logits against 5e-2).  Each run prints, shared
   against unshared, tokens equal, shared_page_hits,
   skipped_prefill_tokens, peak pages and tok/s.
20. qwen2-72b at every published width (d 8192, 64/8 heads: G = 8,
   head_dim 128, d_ff 29568, untied 152064-word head, QKV bias drawn
   N(0, 0.02) from seed 5) with n_layers cut 80 -> 8 (the dense 80 layers,
   ~145 GB in bf16, do not fit one card): phase 19's gates and run (a).
21. Engine stage 4 on phase 3's q = 4 llama3.2-1b (bf16 unless said;
   it runs right after phase 8, before the model is freed).  (a) Tiers
   (1.0, 0.5) at once on one paged, prefix-sharing engine (phase 7's 16
   requests, every other one at tier 1): each tier's tokens equal a
   single-tier engine's on ``slice_rank(params, f)`` bit for bit; every
   tier-1 factor shares its stored storage; lowrank_matmul ran at the
   tier-1 ranks, no factored apply on two GEMMs; the certificates
   finite, tier 0's 0, tier 1's no smaller; tok/s per tier (single-tier
   runs, host clock); informational, two tiers at once against one: the
   16 requests' tok/s on a two-tier and a single-tier engine, alternated,
   and one 8-slot decode step's host and device time on each.  (b) Preemption on a 5-page pool that holds one of
   two requests (prompts of 200 and 210 tokens, 96 new), the priority-1
   one arriving after three blocks, with ``share_prefix`` True and False:
   one preemption, no page left; fp32 streams equal the uninterrupted
   runs bit for bit; bf16 the equal count, and each divergence only where
   the uninterrupted run's top-2 margin is within the bf16 spread (the
   plain versions' bf16 logits against their fp32 ones on the same
   tokens, at that token).  (c) Overload: two tiers, an AdmissionPolicy degrading below
   half the pages free, 800 ms deadlines on every odd uid, pages denied in
   steps 6-12 and 1 s slow steps 10-12 under a StepWatchdog: ok + shed
   + error = 16, shed > 0 each with its RejectedOverload, degraded
   admissions > 0 each with the single-tier tier-1 run's tokens, steps
   10-12 flagged.  (d) nan_logits on one request under the captured
   block: that uid alone errors, every other request has the clean run's
   tokens, graphs replayed, as many captures armed as unarmed.  (e)
   ``run(stop=...)`` after two blocks sheds the queue ("shutdown") and
   finishes the rest with the clean tokens; ``export_inflight`` +
   ``take_queue`` after three steps, resubmitted to a second engine, give
   the uninterrupted tokens (fp32 bit for bit; bf16 under (b)'s rule).

22. h2o-danube-1.8b at full width and depth, no cut (24 layers, d 2560,
   32/8 heads: G = 4, head_dim 80, d_ff 6912, untied 32000-word head,
   sliding window 4096; 1.831 B params), random weights (seed 0),
   spectralized (seed 9), compressed at alpha 0.3, q = 4 (ranks 768 and
   192); it runs after phase 20 and frees its model before the summary.
   (a) The static path at phase 3's shape (greedy_generate, every kernel of
   it launched), gated three ways as phases 19-20: every prefill branch
   teacher-forced in bf16 within 5%, fp32 end to end within 1e-2, and bf16
   end to end against the fp32 reference run: the kernels' error within
   1.2 x (RMS) and 1.5 x (largest logit error) the plain versions' own
   (phases 19-20's rule, the two bf16 runs against each other within 1.2 x
   the reference's spread, is printed beside it: two bf16 runs whose
   roundings part ways independently lie ~sqrt(2) x their error apart).
   (b) Phase 7's engine gates on phase 7's trace (the ring below its
   window; the chunk is inert: a ring is never paged or chunked; zero
   pages reserved), flash_attention launched with the window 4096 and no
   other; one captured decode block profiled (the flat decode kernel over
   the ring: one launch a call).  (c) The window trace: 8 slots, max_len
   20480 (rings of 4096), prompts of 4000, 4032, 4096, 4097, 6144, 6144,
   8192 and 16384 tokens, 96 new each (the first two cross position 4096
   while decoding): every request finishes; bf16 graph == eager bit for
   bit; fp32 greedy tokens of the kernels equal the plain versions'
   (backend "reference", eager) request for request; one prefill group a
   prompt length past the window (the two 6144-token prompts together),
   never padded past it; the cache's bytes equal at max_len 20480 and at
   4096.  Prints the engine's tok/s (host clock), the block's device ms and
   idle share, and the phase's wall seconds.
23. deepseek-v2-236b at every published width (d 5120, 128 heads, MLA:
   q_lora 1536, kv_lora 512, q/k head dim 192 = nope 128 + rope 64, v 128;
   layer 0 dense with d_ff 12288, then 160 routed experts top-6 + 2 shared,
   expert d_ff 1536; vocab 102400, untied head; bf16) with n_layers cut 60 ->
   3 (1 dense + 2 MoE; the dense 60 layers, ~471 GB in bf16, do not fit one
   card; 9.331 B params), random weights (seed 0), spectralized (seed 9),
   compressed at alpha 0.3, q = 4, min_dim 32; it runs after phase 22 and
   frees its model before the summary.  Gates: the reference's compression
   decisions (DEEPSEEK_DECISIONS) and ranks (154/173/461/922/1536); on layer
   1's expert 0 w_gate, q = 4's normalized error <= q = 1's.  (a) The static
   path at phase 3's shape (lowrank_matmul, the batched kernel and the flash
   kernel launched, neither decode kernel); auto vs reference with the
   routing replayed (top-6 and the shared experts), bf16 within 5% and fp32
   within 1e-2.  (b) Phase 7's engine gates on phase 7's trace (paged == flat
   on the flat pool's capacity; the chunks run MLA's absorbed path, the
   monolithic prefill the flash kernel); no linear outside the kernels but
   the absorbed path's products (``dispatch.MLA_OP``: the materialized
   wkv_b, the absorption, the latent scores and context, the w_uv product),
   named and counted; the decode kernels launched 0 times.  (c) Phase 19's
   sharing run (a) at chunk 64 = the page, shared == unshared bit for bit,
   pages shared; the session run (c) reported, not gated (the reference
   fails its own MLA session-reuse case).  (d) One captured decode block
   profiled: device ms, idle share, the batched kernel's share, torch's own
   kernels' time, and the absorbed products' share of an eager decode step
   (profiler ranges).  Prints the phase's wall seconds.
24. llama-3.2-vision-11b at full width and depth, no cut (40 layers: 8
   groups of 4 GQA self blocks, 32/8 heads at hd 128, and a cross block,
   32/32 heads, over 1600 image tokens; d_ff 14336, vocab 128256, untied;
   9.976 B params), random weights (seed 0), spectralized (seed 9),
   compressed at alpha 0.3, q = 4 (ranks 308 and 1229); it runs after
   phase 23 and frees its model before the summary.  Gates: the
   reference's decisions, q = 4's normalized error <= q = 1's on self
   block 0's w_gate.  (a) The static path at phase 3's shape, each row with
   its own SyntheticLM image (lowrank_matmul, flash_attention and
   decode_attention launched); two rows of one prompt and two images give
   other first logits, each equal to a batch of one with its own image
   within 5%; auto vs reference by phase 22's rule (fp32 end to end within
   1e-2, bf16 against the fp32 reference run: RMS 1.2 x, largest 1.5 x the
   plain versions' error).  (b) Phase 7's engine gates on the modality
   trace (MODAL_ENGINE: 8 slots, page 64, max_len 256, 16 pages = half of
   flat; 12 requests of 24-200 prompt tokens and 8-24 new, each with its
   own image): every request finishes, graph == eager and paged == flat
   bit for bit, every kernel of the path launched, no linear outside the
   kernels (the prefill is monolithic: no chunk, no sharing).  (c) Phase
   21's preemption, each request with its own image, 48 new tokens:
   fp32 streams equal the uninterrupted runs bit for bit, bf16 diverging
   only within the spread (``share_prefix`` is inert for the family: one
   engine a dtype).  (d) One captured decode block profiled: device ms,
   idle share, the cross-attention's flash launches (Sq = 1, one a call).
25. whisper-small whole (12 encoder + 12 decoder layers, d 768, 12 heads at
   hd 64, 1500 frames, vocab 51865 padded to 51968; 0.278 B params; rank
   231): phase 24's gates with audio frames in place of images, the error
   gate on decoder layer 0's w_up.
26. The replicated cluster (``serving/cluster.py``) on phase 21's q = 4
   llama3.2-1b, before it is freed: two replicas, each 4 slots, page 64,
   max_len 640, 20 pages (half of its flat pool), prefill chunk 256, decode
   block 8, prefix sharing and the CUDA-graph block, sharing one set of
   weights, each stepped by its own thread on its own CUDA stream; phase
   7's 16 requests.  The reference is one replica serving the trace (its
   time against two replicas', and two replicas' again with the
   interpreter's thread switch interval at 0.2 ms, is printed, not
   gated).  (i) No fault: every root ok with the single replica's tokens
   bit for bit; lowrank_matmul, paged_decode_attention and flash_attention
   launched (counts and the dispatch table printed).  (ii) kill_replica (0, 3): one death whose
   step_error is the injected ReplicaKilled, failovers, and the
   per-compute-path contract (a root that never failed over equals the
   single replica's stream; a failed-over root's credited prefix equals it
   and each resumed tail equals a fresh engine serving that continuation,
   bit for bit); then restart_replica(0) while replica 1 serves four more
   requests, probation, rejoin, two more requests routed after the rejoin,
   each equal to a fresh engine's tokens; graph replays > 0 on every
   engine, the restarted one (which captures its graph while replica 1
   serves) among them; the event log holds replica_dead, failover,
   failover_resumed, replica_restart, replica_probation and replica_rejoin.
   (iii) After a warm-up in the replicas' own threads (a thread's first
   step pays its CUDA set-up), hang_replica at replica 0's third step for 4
   x the replicas' adapted deadline (a 1 s floor): exactly one heartbeat
   miss, failover, the per-path contract, the hung replica drains and
   rejoins with no error.  (iv) A cluster of backend "reference" engines,
   replica 0 dying of one 1.5 s engine step (the watchdog's straggler path,
   above a 1 s floor; its thread then drains it, so export_inflight's
   rewrites run in a replica thread): no kernel launched or captured, every
   path reference.  (v) ``launch/
   serve.py --reduced --replicas 2 --event-log PATH`` in-process, 8
   requests on 2 slots a replica under ``--tiers 1.0,0.5
   --degrade-queue-depth 1``: every request served, each event line
   parses, one degrade event a request, both replicas tagged.  The phase's
   seconds are printed.
27. The examples and ``kernels/ops.py`` on the card: ``experiments.
   compress_and_serve`` at its defaults, ``experiments.continuous_serving``
   plain and with ``--sessions`` through ``main(argv)`` (their own
   assertion: the greedy request equals ``greedy_generate`` bit for bit;
   the captured paged block replayed); each ``ops`` function at one
   main-path shape (the sketch GEMM at llama's w_gate, the low-rank apply
   with batch dims and with phi3.5-moe's stacked experts, the SSD scan at
   zamba2's (1, 512) with raw x̄, the causal flash at (4, 256), the decode
   at B 4 over 288 positions) against the same call under backend
   "reference", within phase 2's tolerances, its kernel's launch count
   rising.  The phase's seconds are printed.
28. Training (``train/train_step.py``, ``launch/train.py``), on phase 3's
   q = 4 llama3.2-1b whole, batch 8 x 256 (2048 tokens), bf16: (1) one
   step's loss and gradients with the kernels and with the plain versions
   (backend "reference") from the same params and batch: the dispatch
   shows lowrank_matmul fused, flash_attention and logits on the kernel
   path, the loss within 1e-2, the global gradient norm within 5e-2, every
   factor leaf's gradient nonzero with cosine >= 0.99 against the plain
   run's; (2) the same at full width on 4 of the 16 layers in fp32 (loss
   1e-4, grad norm 1e-3, cosine 0.9999); (3) eight AdamW steps (lr 1e-5, one
   batch) through ``TrainLoopRunner`` lower the loss; (5) with no copy into
   aligned rows (``_build.ALIGN_COPIES``); one step profiled: device time of
   the forward, the backward (recomputation included) and the optimizer,
   the idle share against the host step, peak memory; (4) a run failed at
   step 5 by ``fail_at``, restored from its step-4 checkpoint (codec raw)
   and resumed to step 8 ends on the uninterrupted run's bits.  Then
   mamba2-130m whole through ``launch/train.py`` with
   ``experiments.train_lowrank_lm --full``'s arguments (alpha 0.5, q 4, batch
   8 x 64) for 10 steps: ssd_scan launched on the forward, the loss finite;
   and ``experiments.train_lowrank_lm`` at its default size for 30 steps,
   its own assertion (final loss < 7.0) gating (at full width the loss
   stays near ln(50280): see MAMBA_FULL_STEPS).  The phase's seconds are
   printed.
29. The multi-device layer (``runtime/distributed.py`` and what runs over
   it), right after phase 28 on its model: eight ranks spawned once on
   cuda:0 under gloo (``distributed.spawn``; the kernels built before), the
   card's compute mode printed and required ``Default``; every input made
   once in this process and handed to the ranks as CUDA IPC handles.  (a)
   distributed RSI on a (2, 4) ("data", "model") mesh of qwen2-72b's w_gate
   (8192 x 29568, bf16, blocks 4096 x 7392, k 2458, q 4, fp32 products
   through sketch_matmul): ||W - U S Vt||_F / ||W||_F within 1e-3
   (relative) of the single-rank ``rsi``'s on the same W and Omega; a
   decaying spectrum of the same width (``synth_spectrum_matrix``) whose
   reconstruction lies within 1e-4 of the single rank's; U on ("data",
   None) and Vt on (None, "model") (block shapes, bits equal across the
   replicating axis); gloo's all-reduce of X (4096 x 2458 fp32 over
   "model") and Y (7392 x 2458 over "data") timed; then once more at mesh
   (1, 1), world 1, under nccl, to the same gate.  (b) expert-parallel MoE
   on one phi3.5-moe layer at full width, compressed (alpha 0.3, q 4: rank
   1229), tokens (8, 256) over "data", 4 experts a rank, capacity factor 8
   (nothing drops): within 1e-4 of max |y| (fp32) and 5e-2 (bf16, phase
   5's) of the single-rank moe_forward over the tokens both route alike,
   at most two routed otherwise.  (c) GPipe over 4 "pod" stages of the q =
   4 llama3.2-1b's 16 layers (its own block, the flash and low-rank
   kernels), batch (8, 256) in 4 microbatches: bit for bit the sequential
   forward over the same microbatches, and within 5e-2 of max |y| of the
   whole batch's; its backward (autograd through the shifts and the psum)
   gives each stage's slice within 5e-2 of max |g| of the single rank's
   gradient of the same loss, leaf by leaf.  (d) PowerSGD over 8 data ranks (rank 8) on one llama
   layer's seven matrices at full width, a shared rank-8 signal plus 0.05
   noise a rank: correlation with the dense mean > 0.7 on each, its bytes
   < dense / 3 (both printed, and both all-reduces timed).  (e) (a)'s
   factors saved from (2, 4) (gathered to rank 0 through the host) and
   restored onto (8, 1): bit for bit the saved blocks.  (f) The
   tensor-parallel program (``sharding/rules.py``) on the q =
   4 llama3.2-1b cut to 2 of its 16 layers, full width, each rank holding
   its blocks under the production rules: (i) one AdamW step (bf16, batch
   8 x 256, the sequence over "model") whose loss and grad norm lie within
   1.5 x the single card's bf16 distance from the fp32 step (+ 1e-3 of it),
   and whose update, assembled from the ranks' blocks, errs from the fp32
   step's by at most 1.2 x (RMS) and 1.5 x (largest) the single card's
   bf16 update (the fp32-anchored rule of phases 19-20); (ii) a prefill of
   those prompts and 8 greedy decode steps over a 264-slot cache split over
   "model" (the ranks' attentions combined by the decode kernel's lse):
   every greedy token equal to the single card's ``greedy_generate``, each
   step's logits within 5e-2 of max |logit|; (iii) each rank's argument
   bytes as its caching allocator counts them (the bytes requested for the
   blocks, the optimizer state, the batch and the cache) within 1 MiB of
   the dry count of the same step (counted on CPU fakes in this process
   before the spawn), the train step's allocated bytes within 1 % of it, and its
   collectives by axis and their count equal to the dry mesh's record, for
   the train, prefill and decode steps; the flash, low-rank, sketch and
   decode kernels launched.  Each sub-phase's seconds (rank 0, between
   barriers) and each kernel's launches on the ranks (every one of the four
   > 0) are printed; the ranks time-share one card, so no time here is a
   multi-card figure.
30. The dry-run against the card (``launch/dryrun.py``, ``roofline/``):
   uncompressed llama3.2-1b at full width in bf16, one card (world 1),
   through one AdamW train step at phase 28's batch (8 x 256), one prefill
   at phase 3's static shape (4 x 256, max_len 288) and one decode step at
   batch 4 over a 288-position cache, each counted on fakes in the dry world
   first and then run on the card: the bytes allocated before the step
   within 1% of the dry-run's ``argument_bytes``, the step's peak
   (``max_memory_allocated``) within 10% of its ``peak_bytes`` (both
   counted from what was allocated before the step was built, cuBLAS's
   workspaces released), the
   dispatch's kernel calls equal to its ``kernels`` op by op, and the step's
   matmul FLOPs (``FlopCounterMode``) within 1% of its matmul FLOPs; device
   busy ms (one profiled call) printed beside max(t_compute, t_memory) at
   the H100's data-sheet rates, not gated.  Then (b) one production cell,
   llama3.2-1b train_4k on the dry 16 x 16 mesh, runs to its end as the
   tensor-parallel program (its rank's blocks, nothing whole that the
   reference splits, and it fits 80 GB: gated) and prints its record and
   its collectives' bytes by kind and by mesh axis.

The line before the card line lists every kernel with its time, its
launches on the main run of the newest path that runs it (``launches_run``;
every run's count beside it, phase 18's runs among them), bound and library
time, the attention kernels' times at head_dim 128 and at G = 1, the sketch
GEMM's at W^T @ X the tied logits, the untied head's logits and phase 18's
fp32 shapes, the low-rank kernel's at M 8, 256, 1024 and Table 4.1's fc1,
the batched kernel's at the decode and skewed occupancies, and phases
19-20's shapes (attention at G = 3 and 8, each w_gate, qwen2's sketch
GEMMs) and phase 22's (flash at hd 80 and at (1, 16384) in the window, the
decode over the wrapped ring, h2o's w_gate at M 4 and 8) and phase 23's
(the MLA flash at q/k 192 / v 128, the batched kernel over 160 experts
every row live and at top-6's decode occupancy, wo and wq_b at M 4 and 8,
the sketch GEMM at an expert's w_gate) and phases 24-25's (the flash
kernel's non-causal shapes), and under ``backward`` phase 2's training
cases of the kernel (its forward's time beside its Function's backward),
each beside its
launches on the same model's run (``launches_run``:
its engine, its flat engine for decode_attention, its compression for the
sketch GEMM, since the compressed heads' logits are low-rank applies).  The line
before it gives, for the seven kernels redesigned for Hopper, their earlier
times as ``PERF.md`` records them (``[earlier]``:
copied, not measured in the run; the parent's kernels are timed by
``--lowrank-only --src`` or ``--ssd-only --src`` in the same call).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
# --src DIR: the package tree to import (default this checkout's src/), so that
# --lowrank-only and --ssd-only can time another checkout's kernels in the same call
SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1]) if "--src" in sys.argv else os.path.join(HERE, "src")
sys.path.insert(0, SRC)



class _KernelCost:
    """This checkout's ``src/repro_torch/roofline/kernel_cost.py``, loaded by
    path on first use: the kernels' (ops, bytes) formulas that every bound
    below divides, whichever tree ``--src`` names (an older tree may have
    no such module)."""

    def __getattr__(self, name):
        import importlib.util

        path = os.path.join(HERE, "src", "repro_torch", "roofline", "kernel_cost.py")
        spec = importlib.util.spec_from_file_location("chip_smoke_kernel_cost", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.__dict__.update(vars(mod))
        return getattr(mod, name)


kernel_cost = _KernelCost()

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

# the dense main paths (phases 19-20): minitron-4b at every published width, n_layers cut 32 -> 16
# (to keep the whole script near its time target: its eager sharing runs scale with depth); qwen2-72b
# at every published width,
# n_layers cut 80 -> 8 (the dense 80 layers, ~145 GB in bf16, do not fit one card)
DENSE_ARCHS = (("minitron-4b", 16), ("qwen2-72b", 8))
DENSE_HEADS = {"minitron-4b": (24, 8, 128), "qwen2-72b": (64, 8, 128)}  # H, KV, head_dim
# each model's w_gate at alpha 0.3 (K, rank, N) and the M phase 2 runs it at
DENSE_W_GATE = (("minitron-4b", (3072, 922, 9216), (4, 8, 64)), ("qwen2-72b", (8192, 2458, 29568), (4, 8)))
SYS_LEN = 128  # the sharing runs' system prompt: 2 pages

# the sliding-window main path (phase 22): h2o-danube-1.8b at full width and depth (no cut)
H2O_ARCH = "h2o-danube-1.8b"
H2O_W_GATE = (2560, 768, 6912)  # its w_gate at alpha 0.3: (K, rank, N)
H2O_LONG_PROMPT = 16384  # phase 2's windowed flash shape, (1, 16384), and the window trace's longest prompt
# the window trace: rings of 4096 slots at max_len 20480; the first two prompts cross
# position 4096 while decoding, the rest are past it at admission
H2O_WINDOW = dict(n_slots=8, max_len=20480, decode_block=8)
H2O_WINDOW_PROMPTS = (4000, 4032, 4096, 4097, 6144, 6144, 8192, H2O_LONG_PROMPT)
H2O_WINDOW_GEN = 96

# the MLA main path (phase 23): deepseek-v2-236b at every published width, n_layers cut 60 -> 3
# (1 dense + 2 MoE layers: the dense 60 layers, ~471 GB in bf16, do not fit one card)
DEEPSEEK_ARCH, DEEPSEEK_LAYERS = "deepseek-v2-236b", 3
DEEPSEEK_E, DEEPSEEK_R, DEEPSEEK_TOPK = 160, 461, 6  # experts, the experts' rank at alpha 0.3, top-k
# phase 2 at its shapes: one MoE layer's expert stacks at the capacity floor (C, K, N), and the
# 2-D low-rank kernel at wo and wq_b (K, rank, N)
DEEPSEEK_BATCHED = [(128, 5120, 1536, "w_gate"), (128, 1536, 5120, "w_down")]
DEEPSEEK_LOWRANK = [(16384, 1536, 5120, "wo"), (1536, 461, 24576, "wq_b")]
# the compression decisions at full width, as the reference makes them (alpha 0.3, min_dim 32):
# every MLA linear, the dense FFN, the routed and shared experts and the head compressed; the
# router, the embedding and the norm scales (q_norm and kv_norm among them) dense
DEEPSEEK_DECISIONS = {
    **{f"{sub}/attn/{n}": True for sub in ("dense_layers", "layers") for n in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")},
    **{f"{sub}/attn/{n}/scale": False for sub in ("dense_layers", "layers") for n in ("q_norm", "kv_norm")},
    **{f"{sub}/{n}/scale": False for sub in ("dense_layers", "layers") for n in ("attn_norm", "mlp_norm")},
    **{f"dense_layers/mlp/{n}": True for n in ("w_gate", "w_up", "w_down")},
    **{f"layers/moe/{g}/{n}": True for g in ("experts", "shared") for n in ("w_gate", "w_up", "w_down")},
    "layers/moe/router/gate_w": False, "lm_head": True, "embed": False,
}
DEEPSEEK_RANKS = [154, 173, 461, 922, 1536]  # wkv_b, wkv_a, wq_a/wq_b/experts, shared, wo/dense FFN/head

# the modality main paths (phases 24-25), each at full width and depth (no cut): llama-3.2-vision-11b
# (9.976 B params, 20.0 GB in bf16; qwen2-72b's 8 layers, 9.51 B, compressed within 48.7 GiB) and
# whisper-small (0.278 B)
VLM_ARCH, WHISPER_ARCH = "llama-3.2-vision-11b", "whisper-small"
MODAL_ARCHS = (VLM_ARCH, WHISPER_ARCH)
MODAL_TAGS = {VLM_ARCH: "vlm", WHISPER_ARCH: "whisper"}
MODAL_PHASES = {VLM_ARCH: 24, WHISPER_ARCH: 25}
# ranks at alpha 0.3: vision's wk/wv (4096 x 1024) and every other linear (min dim 4096); whisper's (768)
MODAL_RANKS = {VLM_ARCH: [308, 1229], WHISPER_ARCH: [231]}
# the modality trace: 8 slots, page 64, max_len 256, 16 pages (half the flat pool); 12 requests of
# 24-200 prompt tokens and 8-24 new ones, each with its own image or frames
MODAL_ENGINE = dict(n_slots=8, max_len=256, page_size=64, kv_pages=16, decode_block=8)
MODAL_REQUESTS, MODAL_PROMPTS, MODAL_GEN = 12, (24, 200), (8, 24)
MODAL_PREEMPT_GEN = 48  # phase 21's preemption pool and prompts, 48 new tokens each
# the flash kernel's non-causal shapes (phase 2): (label, B, Sq, Skv, H = KV, head_dim)
NONCAUSAL_FLASH = [
    ("whisper encoder", 4, 1500, 1500, 12, 64),  # Skv 23.4 tiles of 64: the last tile holds 28 keys
    ("whisper cross prefill", 4, PROMPT, 1500, 12, 64),
    ("whisper cross decode", 8, 1, 1500, 12, 64),  # one live row of a 64-row query tile
    ("vlm cross prefill", 4, PROMPT, 1600, 32, 128),
    ("vlm cross decode", 8, 1, 1600, 32, 128),
    ("one key", 2, 64, 1, 12, 64),
    ("one key past a tile", 2, 64, 65, 12, 64),
]

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


def ptxas_flash_instances(log: str) -> str:
    """The flash library's instances from its ``-Xptxas -v`` log: (kind, q/k
    head dim, v head dim) -> registers and spill bytes."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            dims = re.search(r"flash_(wgmma_kernel|attention_kernel)I(?:f)?Li(\d+)ELi(\d+)E", name)
            entry = None if dims is None else {"kind": "bf16 wgmma" if dims.group(1) == "wgmma_kernel" else "fp32 FMA",
                                                "hd": int(dims.group(2)), "vd": int(dims.group(3)), "spill": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            out.append(entry)
            entry = None
    return "; ".join(f"{e['kind']} ({e['hd']}, {e['vd']}): {e.get('registers')} registers, {e['spill']} bytes spilled"
                     for e in sorted(out, key=lambda e: (e["kind"], e["hd"], e["vd"])))


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


def bound(cost: tuple, dtype_name: str):
    """(ms, what binds) of a kernel's ``(ops, bytes)`` cost (``roofline/kernel_cost.py``)."""
    ops, bytes_moved = cost
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------- #
def check(name, shape, dtype, got, want, rel_tol, reason, *, kernel_fn, plain_fn, library_fn, cost,
          records, key=None, extra=None):
    """Compare, time, and print one JSON line; keep the first bf16 case of
    each kernel (its main-path representative) for the summary, under
    ``key`` (default the kernel's name).  ``cost``: the kernel's (ops,
    bytes) from ``roofline/kernel_cost.py``, its bound's inputs.  ``extra``:
    more fields of the record (another bound, the occupancy)."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ok = err <= rel_tol * scale and bool(torch.isfinite(got.float()).all())
    dname = str(dtype).replace("torch.", "")
    b_ms, b_by = bound(cost, dname)
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
# the prefill plan's cost: each dense model's w_gate (K, rank, N) at the prefill M (16 a short
# prompt, 64 and 256 the chunks, 1024 the static prefill)
PREFILL_W_GATE = (("llama3.2-1b", (2048, 615, 8192)), ("minitron-4b", (3072, 922, 9216)),
                  ("qwen2-72b", (8192, 2458, 29568)))
PREFILL_M = (16, 64, 256, 1024)
# the batched kernel at phi3.5-moe's shapes: 16 experts, rank 1229 (ceil(0.3 * 4096)); (C, K, N)
BATCHED_SHAPES = [(128, 4096, 6400, "decode w_gate"), (128, 6400, 4096, "decode w_down"), (640, 4096, 6400, "prefill")]
MOE_E, MOE_R, MOE_SLOTS, MOE_TOPK = 16, 1229, 8, 2


def moe_decode_counts(occupancy: str, E: int = MOE_E, top_k: int = MOE_TOPK):
    """Capacity rows filled per expert: "full" every row; "decode" the decode
    occupancy, 8 tokens x top-k distinct experts of E drawn with numpy seed 0
    (phi3.5-moe: top-2 of 16; deepseek-v2: top-6 of 160); "skewed" all 16 of
    phi's assignments on 2 experts (the synthetic router's skew)."""
    import numpy as np

    if occupancy == "decode":
        rng = np.random.default_rng(0)
        ids = np.stack([rng.choice(E, size=top_k, replace=False) for _ in range(MOE_SLOTS)])
        return np.bincount(ids.reshape(-1), minlength=E)
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
    cases += [(torch.bfloat16, M, K, r, N, f"{arch} w_gate") for arch, (K, r, N) in PREFILL_W_GATE
              for M in PREFILL_M]
    plan_ms = {}
    for dtype, M, K, r, N, label in cases:
        rel, why = gemm_tol[dtype]
        x, A, B = rnd((M, K), dtype), aligned_rows(rnd((K, r), dtype)), aligned_rows(rnd((r, N), dtype))
        got = lowrank_matmul(x, A, B)
        # each M's w_gate case is its summary row (M 4 under the kernel's own name); the prefill
        # plan's w_gate rows under their model's name
        key = None if dtype != torch.bfloat16 or (K, r, N) != LOWRANK_LLAMA[0] or label else (
            "lowrank_matmul" if M == LOWRANK_M[0] else f"lowrank_matmul M {M}")
        if label and label.endswith("w_gate"):
            key = f"lowrank_matmul {label} M {M}"
        check("lowrank_matmul", [M, K, r, N] + ([label] if label else []), dtype, got,
              ref.lowrank_matmul_ref(x, A, B), rel, why,
              kernel_fn=lambda: lowrank_matmul(x, A, B),
              plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
              cost=kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()), records=records if key else {}, key=key)
        if key and label:
            plan_ms[f"{label} M {M}"] = {f: records[key][f] for f in ("ms", "library_ms", "bound_ms")}
        del x, A, B, got
    say(f"[prefill plan] w_gate at the prefill M, the plans of {SRC}: " + json.dumps(plan_ms))
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
        all_ms, all_by = bound(kernel_cost.lowrank_matmul_batched(E, C, K, r, N, esz), str(dtype).replace("torch.", ""))
        key = f"lowrank_matmul_batched {occ}" if occ != "full" and label == "decode w_gate" else None
        check("lowrank_matmul_batched", [E, C, K, r, N, label, f"{occ} occupancy"], dtype, got, want, rel, why,
              kernel_fn=lambda: lowrank_matmul_batched(x, A, B),
              plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.bmm(torch.bmm(x, A), B),  # bmm rounds t to x's dtype, as the kernel
              cost=kernel_cost.lowrank_matmul_batched(E, C, K, r, N, esz, live_experts=n_live, live_rows=rows),
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


def attention_tolerances() -> dict:
    import torch

    return {torch.bfloat16: (2e-2, "bf16: p is rounded before PV (unnormalized in the kernel, "
                             "normalized in the plain decode version) and the output is rounded"),
            torch.float32: (1e-4, "fp32 online softmax vs one-pass softmax, another summation order")}


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
    attn_tol = attention_tolerances()

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
                  cost=kernel_cost.sketch_matmul(C, D, ell, W.element_size(), trans_a=trans),
                  records=records if storage == "aligned_rows" else {},
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
                  cost=kernel_cost.decode_attention(Bq, S, H, KV, hd, q.element_size(), n_rows=n_rows),
                  records=records)
        # the lse variant (the tensor-parallel decode over a cache split across ranks combines by it), at
        # the prefix mask: its output bit for bit the plain launch's, each head's fp32 lse against the plain
        # version's
        valid = prefix.contiguous()
        got, lse = decode_attention(q, k, v, valid, return_lse=True)
        if not torch.equal(got, decode_attention(q, k, v, valid)):
            fail("decode_attention: the lse variant's output differs from the plain launch's")
        mask = valid[:, None, None, :]
        check("decode_attention", [Bq, S, H, KV, hd, "prefix mask, lse (B, H) fp32"], dtype, lse,
              ref.decode_attention_ref(q, k, v, valid, return_lse=True)[1], rel, why,
              kernel_fn=lambda: decode_attention(q, k, v, valid, return_lse=True),
              plain_fn=lambda: ref.decode_attention_ref(q, k, v, valid, return_lse=True),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
              cost=kernel_cost.decode_attention(Bq, S, H, KV, hd, q.element_size(), n_rows=int(valid.sum())),
              records=records, key="decode_attention lse" if dtype == torch.bfloat16 else None)

        # prefill attention: S 256 (the main path), S 200 (a ragged tile), S 200 with a window
        for S, window in ((PROMPT, None), (200, None), (200, 64)):
            q, k, v = rnd((Bq, S, H, hd), dtype), rnd((Bq, S, KV, hd), dtype), rnd((Bq, S, KV, hd), dtype)
            got = flash_attention(q, k, v, causal=True, window=window)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            # the library call: causal SDPA, or SDPA under the same causal-window mask
            win_mask = ref.attention_mask(S, S, causal=True, window=window, q_offset=0, device=dev)
            check("flash_attention", [Bq, S, H, KV, hd, window], dtype, got,
                  ref.chunked_attention_ref(q, k, v, causal=True, window=window), rel, why,
                  kernel_fn=lambda: flash_attention(q, k, v, causal=True, window=window),
                  plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True, window=window),
                  library_fn=(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True))
                  if window is None else
                  (lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=win_mask, enable_gqa=True)),
                  cost=kernel_cost.flash_attention(Bq, S, S, H, KV, hd, q.element_size(), window=window),
                  records=records)

    phase_paged_kernel(rnd, gen, attn_tol, records)
    phi = phase_moe_kernels(rnd, gen, gemm_tol, attn_tol, records)
    g1 = phase_ssm_kernels(rnd, gen, records)
    dense = phase_dense_kernels(rnd, gen, gemm_tol, attn_tol, records)
    phase_h2o_kernels(rnd, gen, gemm_tol, attn_tol, records)
    phase_deepseek_kernels(rnd, gen, gemm_tol, attn_tol, records)
    phase_noncausal_kernels(rnd, gen, attn_tol, records)

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
          cost=kernel_cost.sketch_matmul(128256, 2048, BATCH, E.element_size(), out_itemsize=4), records=records,
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
              cost=kernel_cost.sketch_matmul(d, V, n, head.element_size(), trans_a=True, out_itemsize=4),
              records=records if main_form else {}, key="sketch_matmul untied head")
    del head, x, xT
    torch.cuda.empty_cache()
    return records, phi, g1, dense


def phase_moe_kernels(rnd, gen, gemm_tol, attn_tol, records):
    """The MoE path's kernels at phi3.5-moe's shapes: the batched low-rank
    kernel on one layer's expert stacks (16 experts, rank 1229, factors as a
    view of a row-padded (L, E, K, r) leaf), and the three attention kernels
    at 32/8 heads, head_dim 128.  Returns {kernel: bf16 record} of the
    attention kernels at head_dim 128."""
    import torch

    phase_batched_kernels(rnd, gemm_tol, records)
    phi: dict = {}
    phase_attention_kernels(rnd, gen, attn_tol, 32, 8, 128, phi, "phi")
    torch.cuda.empty_cache()
    return phi


def phase_attention_kernels(rnd, gen, attn_tol, H, KV, hd, out, tag):
    """The three attention kernels at H/KV heads and head_dim ``hd``, bf16 and
    fp32, at the engine's shapes: the flash prefill at the static (4, 256),
    decode over the flat engine's cache (8 slots, max_len 640, ragged fill,
    one empty slot), and paged decode through the engine's block table (page
    64, 10 pages a slot), bit for bit the flat kernel.  The bf16 records go
    into ``out``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention

    dev = torch.device("cuda")
    Bq = ENGINE["n_slots"]
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        q, k, v = rnd((BATCH, PROMPT, H, hd), dtype), rnd((BATCH, PROMPT, KV, hd), dtype), rnd((BATCH, PROMPT, KV, hd), dtype)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention(q, k, v, causal=True)
        check("flash_attention", [BATCH, PROMPT, H, KV, hd, None], dtype, got,
              ref.chunked_attention_ref(q, k, v, causal=True), rel, why,
              kernel_fn=lambda: flash_attention(q, k, v, causal=True),
              plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True),
              cost=kernel_cost.flash_attention(BATCH, PROMPT, PROMPT, H, KV, hd, q.element_size()), records=out)
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
              cost=kernel_cost.decode_attention(Bq, S, H, KV, hd, q.element_size(), n_rows=n_rows), records=out)
        page, n_tbl = ENGINE["page_size"], -(-ENGINE["max_len"] // ENGINE["page_size"])
        P = Bq * n_tbl + 1
        kp, vp = rnd((P, page, KV, hd), dtype), rnd((P, page, KV, hd), dtype)
        kp[-1], vp[-1] = 1e4, -1e4
        bt = torch.randperm(P - 1, generator=gen, device=dev)[: Bq * n_tbl].reshape(Bq, n_tbl).to(torch.int32)
        nv = n_valid.to(torch.int32)
        got = paged_decode_attention(q, kp, vp, bt, nv)
        flat = decode_attention(q, ref.gather_pages(kp, bt), ref.gather_pages(vp, bt), valid)
        if not bool(torch.equal(got, flat)):
            fail(f"paged_decode_attention at page 64, {H}/{KV} heads, head_dim {hd} ({dtype}) differs from the flat "
                 f"kernel")
        ks, vs = ref.gather_pages(kp, bt).transpose(1, 2), ref.gather_pages(vp, bt).transpose(1, 2)
        check("paged_decode_attention", [Bq, page, n_tbl, H, KV, hd, "ragged n_valid"], dtype, got,
              ref.paged_decode_attention_ref(q, kp, vp, bt, nv), rel, why,
              kernel_fn=lambda: paged_decode_attention(q, kp, vp, bt, nv),
              plain_fn=lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, nv),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True),
              cost=kernel_cost.paged_decode_attention(Bq, n_tbl, H, KV, hd, q.element_size(), n_rows=n_rows),
              records=out)
        say(f"[{tag} kernels] paged == flat kernel bit for bit at page 64, {H}/{KV} heads, head_dim {hd}, "
            f"{dtype}: True")
        del q, k, v, kp, vp, qs, ks, vs, got, flat
    torch.cuda.empty_cache()


def phase_dense_kernels(rnd, gen, gemm_tol, attn_tol, records) -> dict:
    """Phase 2 at the shapes of phases 19-20 (bf16 but where stated): the
    three attention kernels at minitron-4b's 24/8 heads (G = 3) and
    qwen2-72b's 64/8 (G = 8), head_dim 128, bf16 and fp32; lowrank_matmul at
    minitron's w_gate (3072 x 922 x 9216) at M 4, 8 and 64 (the sharing
    runs' chunk) and qwen2's (8192 x 2458 x 29568) at M 4 and 8; the sketch
    GEMM at qwen2's w_gate, W @ Y and W^T @ X (trans_a), operands in the
    storage RSI gives them.  Returns {arch: {kernel: bf16 record}} of the
    attention kernels; the GEMMs' records go into ``records``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.kernels.sketch_matmul import sketch_matmul

    by_arch: dict = {}
    for arch, (H, KV, hd) in DENSE_HEADS.items():
        by_arch[arch] = {}
        phase_attention_kernels(rnd, gen, attn_tol, H, KV, hd, by_arch[arch], arch.split("-")[0])
    rel, why = gemm_tol[torch.bfloat16]
    for arch, (K, r, N), Ms in DENSE_W_GATE:
        short = arch.split("-")[0]
        A, B = aligned_rows(rnd((K, r), torch.bfloat16)), aligned_rows(rnd((r, N), torch.bfloat16))
        for M in Ms:
            x = rnd((M, K), torch.bfloat16)
            check("lowrank_matmul", [M, K, r, N, f"{arch} w_gate"], torch.bfloat16, lowrank_matmul(x, A, B),
                  ref.lowrank_matmul_ref(x, A, B), rel, why,
                  kernel_fn=lambda: lowrank_matmul(x, A, B), plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
                  library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
                  cost=kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()),
                  records=records, key=f"lowrank_matmul {short} M {M}")
            del x
        del A, B
        torch.cuda.empty_cache()
    (K, r, N) = DENSE_W_GATE[-1][1]  # RSI's sketch GEMMs on qwen2's w_gate, rank l = 2458
    W = rnd((K, N), torch.bfloat16)
    for trans, other in ((False, (N, r)), (True, (K, r))):
        Y = aligned_rows(rnd(other, torch.bfloat16))
        M_out = N if trans else K
        check("sketch_matmul", [M_out, other[0], r, "trans_a" if trans else "plain", "qwen2-72b w_gate"],
              torch.bfloat16, sketch_matmul(W, Y, trans_a=trans), ref.sketch_matmul_ref(W, Y, trans_a=trans), rel,
              why, kernel_fn=lambda: sketch_matmul(W, Y, trans_a=trans),
              plain_fn=lambda: ref.sketch_matmul_ref(W, Y, trans_a=trans),
              library_fn=lambda: torch.matmul(W.T if trans else W, Y),
              cost=kernel_cost.sketch_matmul(K, N, r, W.element_size(), trans_a=trans), records=records,
              key="sketch_matmul qwen2 trans_a" if trans else "sketch_matmul qwen2")
        del Y
    del W
    torch.cuda.empty_cache()
    return by_arch


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
                  cost=kernel_cost.paged_decode_attention(Bq, n_tbl, H, KV, hd, q.element_size(), n_rows=n_rows),
                  records=records)
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
    (each Mamba2 layer's mixer; a hybrid shared block's or a dense layer's
    attention and its MLP) run under "auto" and under "reference" on the SAME input, built
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
        elif lm_mod._layer_kind(cfg) == "mamba":
            lp = lm_mod._layer(params["layers"], i)
            h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
            x = x + branch(f"layer {i} mamba", lambda: ssm_mod.mamba2_forward(lp["mamba"], h, cfg))
        else:  # a dense layer
            lp = lm_mod._layer(params["layers"], i)
            h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
            x = x + branch(f"layer {i} attention", lambda: attn.gqa_forward(lp["attn"], h, cfg, positions=positions))
            h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
            x = x + branch(f"layer {i} mlp", lambda: moe_mod.ffn_forward(lp["mlp"], h))
    say(f"[{tag}] every prefill branch teacher-forced (auto vs reference on the same input, {B}x{S} tokens): "
        f"within {rel} x max |branch output| in all {n} branches; worst {where} (ratio {worst:.3f})")
    return worst


def phase_deep_reference(model, params, batch, tag: str, *, fp32_anchored: bool = False) -> dict:
    """Auto vs reference end to end for the recurrent families and the deep
    dense models: the prefill logits and the first decode step's (both runs
    fed auto's first token).

    In fp32 the kernels differ from their plain versions by summation order
    only (each within 1e-4 in phase 2): held to 1e-2 of max |logit|, room
    for the recurrent layers' amplification of that.  In bf16 a one-ulp
    difference anywhere is amplified through 38 (24) recurrent layers as
    much as the model's own bf16 rounding is: the reference itself, with
    only its scan's summation order changed (the plain scan at the kernel's
    64-step chunk against its own chunk rule), moves by ``spread``, and bf16
    is held to 2 x spread + 0.05 of max |logit|, which a wrong kernel (O(1)
    off) cannot meet.  A dense model has no such knob, and through 32 layers
    of random spectralized weights its bf16 logits lie as far from its own
    fp32 run as from the kernels' bf16 run (minitron-4b on an H100: 8.0% and
    7.9% of max |logit| at the first decode step): there ``spread`` is the
    reference's bf16 logits against its fp32 ones, both fed the kernels'
    bf16 token, and the kernels' bf16 run is held to 1.2 x spread, so a bf16
    path whose error is twice the reference's own fails.  The
    branch-by-branch check (phase_blocks_reference) holds each kernel to its
    bf16 tolerance in place, and the plain 5% comparison is printed.

    ``fp32_anchored`` (phases 19-20, 22, 24 and 25): the dense bf16 rule measures
    each bf16 run against the fp32 reference run (fed the same token)
    instead of one against the other.  The kernels' bf16 logits' RMS error
    is held to 1.2 x the plain versions' bf16 RMS error and their largest
    error to 1.5 x the plain versions' largest, so a bf16 path whose error
    is twice the reference's own still fails.  The rule above compares two
    bf16 runs whose roundings part ways independently, which lie ~sqrt(2)
    x each one's error apart, so it fails a kernel path exactly as accurate
    as the plain one.  That rule's reading is printed beside it, and again
    with each of the flash and low-rank kernels swapped for its plain
    version (``plain_kernel``): PERF.md section 6 has h2o-danube's."""
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

    def rms(a, b, i):
        return float((a[i] - b[i]).pow(2).mean().sqrt()) / float(b[i].pow(2).mean().sqrt())

    def to32(t):
        return {k: to32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    out = {}
    recurrent = model.cfg.family in ("ssm", "hybrid")
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
    del auto, ref
    torch.cuda.empty_cache()

    auto = run(model, params, "auto")
    ref = run(model, params, "reference", auto[1])
    swapped = {}
    if fp32_anchored:
        for op in ("flash_attention", "lowrank_matmul"):
            with plain_kernel(op):
                swapped[op] = run(model, params, "auto", auto[1])
    if recurrent:
        moved, how = run(build_model(dataclasses.replace(model.cfg, ssm_chunk=SSD_CHUNK)), params, "reference",
                         auto[1]), f"the reference at scan chunk {SSD_CHUNK} vs its own rule"
    else:
        moved, how = run(m32, p32, "reference", auto[1]), "the reference's fp32 run vs its bf16 one"
    del m32, p32
    torch.cuda.empty_cache()
    for i, what, key in ((0, "prefill", "prefill"), (2, "first decode step", "decode")):
        e, spread = err(auto, ref, i), err(moved, ref, i)
        tol, rule = (2 * spread + 0.05, "2 x that + 0.05") if recurrent else (1.2 * spread, "1.2 x that")
        out[f"bf16_{key}"], out[f"bf16_{key}_spread"] = e, spread
        say(f"[{tag}] bf16 {what} logits: auto vs reference max abs err {e:.4e} x max |reference| (5e-2: "
            f"{'within' if e <= 5e-2 else 'beyond'}); {how} {spread:.4e}; tol {rule} = {tol:.4e}"
            + (f" (ratio {e / spread:.3f}; printed, not gated: fp32-anchored rule below)" if fp32_anchored else ""))
        if fp32_anchored:  # each bf16 run against the fp32 reference run (``moved``), fed the same token
            # phases 19-20's rule with one kernel at a time swapped for its plain version (printed only)
            for op, run_swapped in swapped.items():
                say(f"[{tag}] bf16 {what} logits with {op} swapped for its plain version: auto vs reference "
                    f"{err(run_swapped, ref, i):.4e} = {err(run_swapped, ref, i) / spread:.3f} x the spread")
            ratios = {"rms": rms(auto, moved, i) / rms(ref, moved, i), "max": err(auto, moved, i) / err(ref, moved, i)}
            out[f"bf16_{key}_vs_fp32_ratio"] = ratios
            say(f"[{tag}] bf16 {what} logits against the fp32 reference: the kernels' error / the plain versions' "
                f"error, RMS {ratios['rms']:.3f} (tol 1.2), largest {ratios['max']:.3f} (tol 1.5)")
            if not (ratios["rms"] <= 1.2 and ratios["max"] <= 1.5 and bool(torch.isfinite(auto[i]).all())):
                fail(f"{tag}: bf16 {what} logits: the kernels' error against fp32 is {ratios} x the plain "
                     f"versions' (tol RMS 1.2, largest 1.5)")
        elif not (e <= tol and bool(torch.isfinite(auto[i]).all())):
            fail(f"{tag}: bf16 {what} logits, auto vs reference {e:.4e} > {tol:.4e}")
    same = int((auto[1] == run(model, params, "reference")[1]).sum())
    say(f"[{tag}] first generated tokens, auto vs reference: {same}/{auto[1].shape[0]} equal")
    return out


@contextlib.contextmanager
def plain_kernel(op: str):
    """Within the extent, dispatch's ``op`` (flash_attention or
    lowrank_matmul) runs its plain version where it would launch its
    kernel; the other ops keep theirs.  A diagnostic of the bf16 gates
    only: the port has no such switch."""
    from repro_torch.kernels import ref
    from repro_torch.runtime import dispatch

    attr, plain = {"flash_attention": ("_flash_kernel", lambda q, k, v, **kw: ref.chunked_attention_ref(q, k, v, **kw)),
                   "lowrank_matmul": ("_lowrank_kernel", lambda x, A, B, **kw: ref.lowrank_matmul_ref(x, A, B))}[op]
    kernel = getattr(dispatch, attr)
    setattr(dispatch, attr, plain)
    try:
        yield
    finally:
        setattr(dispatch, attr, kernel)


def phase_reference(model, params, batch, tag: str = "reference", rel: float = 5e-2):
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

    # rel, of the reference logits' max |value|: 5e-2 in bf16 (activations through every layer,
    # each side rounding the same intermediates but possibly landing one ulp apart); 1e-2 in fp32
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
# the profiler's own and the port's record_function ranges: on the device side they span whole
# regions (idle gaps included), not work
ANNOTATIONS = ("ProfilerStep", "train_step.")


def device_rows(prof, per: int = 1) -> list:
    """(device us, count, kernel name) of every device-side event of a
    ``torch.profiler`` trace, divided by ``per`` runs, largest first.  Only
    device events: a CPU op's row repeats its kernels' time."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # a scheduled profile's step annotation and the train step's ranges span device idle time too
        if getattr(e, "device_type", None) != DeviceType.CUDA or e.key.startswith(ANNOTATIONS):
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
                   if getattr(e, "device_type", None) == DeviceType.CUDA and e.time_range.end > e.time_range.start
                   and not e.name.startswith(ANNOTATIONS))
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


def serve(model, params, label, *, libs, tag: str = "engine", base=None, requests=engine_requests, **kw):
    """One engine run over ``requests(cfg)`` (default the 16 requests) on an
    engine of ``base`` (default ``ENGINE``) updated by ``kw``, counts reset
    just before and read just after; returns (tokens per request, engine,
    launches, tok/s)."""
    import torch

    from repro_torch.runtime import dispatch
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.serving import Engine

    opts = dict(ENGINE if base is None else base)
    opts.update(kw)
    eng = Engine(model, params, **opts)
    reqs = requests(model.cfg)
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
                 dense_ok=frozenset(), requests=engine_requests, base=None):
    """The engine's gates on ``model``.  ``dense_ok``: the (K, N) of linears
    the compression policy left dense (below min_dim), the only products
    allowed outside the low-rank kernels.  Paged == flat runs the paged
    engine on half the flat pool's pages, a moe model on the flat pool's
    capacity.  For the ssm and hybrid families also: every prefill micro-batch holds
    one prompt length, unpadded; the SSD kernel launched once per layer per
    prefill call; mamba2 (no paged leaf) reserved zero pages.  Their prefill is monolithic (the chunk is
    inert), so the chunked-vs-monolithic check is the attention families'.
    ``requests`` and ``base``: another trace and engine (phases 24-25:
    requests with their own images or frames, ``MODAL_ENGINE``)."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.runtime import dispatch

    libs = engine_libs()
    trace = dict(requests=requests, base=base)
    main_tok, eng, launches, tps = serve(model, params, "paged + chunked, CUDA graph (main path)", libs=libs,
                                         tag=tag, **trace)
    say(f"[{tag}] dispatch table of the main run (calls that ran; graph calls counted per replay):")
    for line in dispatch.format_counters().splitlines():
        say(f"[{tag}]   {line}")
    missing = [n for n in on_path if launches[n] <= 0]
    if missing:
        fail(f"kernels never launched on the {tag} main path: {missing}")
    W = model.cfg.sliding_window
    if W is not None:  # the prefill attends through the window
        windows = sorted({k[2][3] for k in dispatch.counters() if k[0] == "flash_attention"}, key=str)
        say(f"[{tag}] flash_attention windows on the main run: {windows} (the arch's: {W})")
        if windows != [W]:
            fail(f"{tag}: flash_attention ran with windows {windows}, not the arch's {W}")
    # every low-rank apply of the main run went through a kernel: no plain version, and no dense
    # product but those of linears the policy left dense; an MLA model's absorbed-path products
    # (the reference's XLA einsums, no Pallas kernel) are named and counted, nothing else
    mla = model.cfg.family == "moe" and bool(model.cfg.kv_lora_rank)
    plain = {k: n for k, n in dispatch.counters().items()
             if (k[0] == "dense" and tuple(k[2]) not in dense_ok)
             or (k[0] == "lowrank_matmul" and k[1] not in ("fused", "fused_batched"))
             or (k[0] == dispatch.MLA_OP and not mla)}
    if plain:
        fail(f"the {tag} main path ran linears outside the kernels: {plain}")
    if mla:
        absorbed = {}
        for (op, _, sig), n in dispatch.counters().items():
            if op == dispatch.MLA_OP:
                absorbed[sig[0]] = absorbed.get(sig[0], 0) + n
        say(f"[{tag}] outside the kernels, by name: the {dispatch.MLA_OP} products, {sum(absorbed.values())} calls "
            f"by product {absorbed}; decode_attention launches {launches['decode_attention']}, "
            f"paged_decode_attention launches {launches['paged_decode_attention']} (the MLA decode is in latent "
            f"space)")
        if not absorbed or launches["decode_attention"] or launches["paged_decode_attention"]:
            fail(f"{tag}: {dispatch.MLA_OP} products {absorbed}, decode kernel launches "
                 f"{launches['decode_attention']} / {launches['paged_decode_attention']}")
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
    eager_tok, *_ = serve(model, params, "paged + chunked, eager", libs=libs, tag=tag, cuda_graph=False, **trace)
    if eager_tok != main_tok:
        fail(f"{tag}: CUDA-graph tokens differ from the eager run's")
    say(f"[{tag}] CUDA-graph tokens == eager tokens: True")
    # A dense or recurrent model's rows never meet in a product, and a prompt
    # row is computed the same way whichever rows share its prefill call (the
    # low-rank kernel's prefill plan: no skinny kernel, a K split fixed by K
    # and N; kernels/lowrank_matmul.py).  So the paged run admits on half the
    # flat pool's pages (other micro-batches, other decode batches) and must
    # still emit the flat run's tokens.  A moe layer's capacity drops depend
    # on which rows share a call, so there the paged pool gets the flat
    # pool's capacity, the two runs form the same micro-batches, and what
    # differs is only where the bytes live.
    moe = model.cfg.family == "moe"
    paged_tok, *_ = serve(model, params, "paged, no chunking" + (", flat-equal pool" if moe else ""), libs=libs,
                          tag=tag, prefill_chunk=None, **({"kv_pages": None} if moe else {}), **trace)
    flat_tok, _, flat_launches, _ = serve(model, params, "flat, no chunking", libs=libs, tag=tag, page_size=None,
                                          kv_pages=None, prefill_chunk=None, **trace)  # counts reset again inside
    if paged_tok != flat_tok:
        fail(f"{tag}: paged-engine tokens differ from the flat engine's")
    say(f"[{tag}] paged tokens == flat tokens: True")
    if model.cfg.family != "ssm" and not mla and flat_launches["decode_attention"] <= 0:
        fail(f"the {tag} flat run never launched decode_attention")
    if mla and flat_launches["decode_attention"]:
        fail(f"the {tag} flat run launched decode_attention {flat_launches['decode_attention']} times (MLA: none)")
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
    decoding; the trace of one block (one replay) must name the paged kernel
    (a sliding-window arch: the flat decode kernel over its ring, which is
    never paged).  For a moe model, also the device time of the batched
    kernel's tiles.  A vlm or audio model's requests carry their own image
    or frames, and its block's cross-attention runs the flash kernel at
    Sq = 1: one launch a call in the trace, its device time reported."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import modality_extras
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
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
        eng.submit(Request(prompt=rng.integers(0, model.cfg.vocab, size=64), max_new_tokens=256,
                           extras=modality_extras(model.cfg, rng)))
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
    ring = model.cfg.sliding_window is not None
    mla = model.cfg.family == "moe" and bool(model.cfg.kv_lora_rank)
    attn_lib, rows_tag, what = ((decode_mod.KERNEL, "FlatRows", "ring") if ring
                                else (paged_mod.KERNEL, "PagedRows", "paged"))
    libs = (attn_lib, lowrank_mod.KERNEL, sketch_mod.KERNEL, batched_mod.KERNEL, flash_mod.KERNEL)
    replays, before = eng.graph_replays, [lib.launches for lib in libs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()  # one block: the state copied in, one replay, the drain
    # wrapper calls in the replayed block (graph launches count once per replay)
    calls, lowrank_calls, sketch_calls, batched_calls, flash_calls = (lib.launches - b
                                                                      for lib, b in zip(libs, before))
    if eng.graph_replays != replays + 1:
        fail("the profiled engine step did not replay the decode graph exactly once")
    if eng.n_active != ENGINE["n_slots"]:
        fail(f"a slot finished inside the decode-block profile ({eng.n_active} of {ENGINE['n_slots']} active)")
    rows = device_rows(prof)
    names = " ".join(r[2] for r in rows)
    # one kernel launch a decode call: the trace's launches of kernels built on PagedRows (FlatRows
    # for a ring) equal the wrapper's calls, and no second pass (combine) runs beside them; an MLA
    # model decodes in latent space through torch ops, and neither decode kernel runs
    paged_rows = [r for r in rows if rows_tag in r[2] or "FlatRows" in r[2]] if mla else \
        [r for r in rows if rows_tag in r[2]]
    paged_launches, paged_ms = sum(r[1] for r in paged_rows), sum(r[0] for r in paged_rows) / 1e3
    if mla:
        say(f"[{tag}] MLA decode: {calls} paged-kernel calls, {paged_launches} decode-kernel launches in the trace "
            f"(none expected: the absorbed path)")
        if calls or paged_launches:
            fail(f"{tag}: the MLA decode block ran {calls} paged decode calls, {paged_launches} decode launches")
    else:
        if rows_tag not in names:
            fail(f"the trace of one decode-block replay does not name the {what} decode kernel: {names[:400]}")
        say(f"[{tag}] {what} decode: {calls} calls, {paged_launches} kernel launches in the trace "
            f"({', '.join(sorted({r[2][:60] for r in paged_rows}))}), {paged_ms:.4f} ms device")
        if calls <= 0 or paged_launches != calls or "combine_kernel" in names:
            fail(f"{tag}: {calls} {what} decode calls ran {paged_launches} {rows_tag} kernel launches (one a call "
                 f"expected)")
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
           f"block_{what}_ms": paged_ms, f"block_{what}_launches": paged_launches,
           "block_lowrank_calls": lowrank_calls, "block_lowrank_launches": lowrank_launches,
           "block_lowrank_ms": lowrank_ms}
    cross = model.cfg.family in ("vlm", "audio")
    flash_rows = [r for r in rows if "flash_wgmma_kernel" in r[2]]
    flash_launches, flash_ms = sum(r[1] for r in flash_rows), sum(r[0] for r in flash_rows) / 1e3
    if cross:  # cross-attention at Sq = 1 through the flash kernel, captured
        out.update(block_flash_ms=flash_ms, block_flash_launches=flash_launches, block_flash_calls=flash_calls)
        say(f"[{tag}] cross-attention (flash, Sq = 1, non-causal): {flash_calls} calls, {flash_launches} kernel "
            f"launches in the trace, {flash_ms:.4f} ms device ({flash_ms / device_ms:.3f} of the block) on "
            f"{card_line()}")
        if flash_calls <= 0 or flash_launches != flash_calls:
            fail(f"{tag}: {flash_calls} cross-attention calls ran {flash_launches} flash launches (one a call)")
    elif flash_calls or flash_launches:
        fail(f"{tag}: a decode block without cross-attention ran {flash_calls} flash calls")
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
    if mla:
        own = sum(r[0] for r in rows if OWN_KERNELS.search(r[2])) / 1e3
        out["block_torch_kernels_ms"] = kernel_ms - own
        say(f"[{tag}] torch's own kernels in the block (the {ENGINE['decode_block']} steps' absorbed MLA products, "
            f"MoE dispatch and combine, norms, rotary, routing): {kernel_ms - own:.3f} ms of {kernel_ms:.3f} ms "
            f"kernel time")
        out.update(mla_absorbed_share(model, params, eng))
    return out


def phase_chunk_profile(model, params, calls: int = 5, tag: str = "chunk"):
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
    say(f"[{tag}] one prefill chunk (1, {C}) at position {C} of a {2 * C}-token prompt: host {wall * 1e3:.3f} ms "
        f"(profiler off, mean of {calls}); device busy {device_ms:.3f} ms (profiler): hand-written kernels "
        f"{own_ms:.3f} ms, other torch kernels {device_ms - own_ms:.3f} ms; {n_launch} device kernels, "
        f"{cpu_ops} aten ops; idle share {max(0.0, 1 - device_ms / (wall * 1e3)):.3f}")
    for us, n, key in rows[:10]:
        say(f"[{tag}]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:100]}")
    return {"chunk_host_ms": wall * 1e3, "chunk_device_ms": device_ms, "chunk_own_kernels_ms": own_ms}


# --------------------------------------------------------------------------- #
# phase 21: engine stage 4 (rank tiers, preemption, overload, faults, the drain)
# --------------------------------------------------------------------------- #
TIERS = (1.0, 0.5)
# preemption: a pool of 5 pages of 64 holds one request of ~200 + 96 tokens, not two
PREEMPT = dict(n_slots=2, max_len=320, page_size=64, kv_pages=5, prefill_chunk=256, decode_block=8)
PREEMPT_LENS, PREEMPT_GEN = (200, 210), 96


def params_fp32(params):
    """The params tree in fp32, factors in the storage the model keeps them in
    (``lowrank_params``: row-padded, so the kernels read them in place)."""
    from repro_torch.core.lowrank import is_lowrank, lowrank_params

    if is_lowrank(params):
        return lowrank_params(params["a"].float(), params["b"].float())
    if isinstance(params, dict):
        return {k: params_fp32(v) for k, v in params.items()}
    return params.float()


def fresh(reqs, **kw):
    """New requests with the same prompts and budgets (and ``kw``)."""
    from repro_torch.serving import Request

    return [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens, **kw) for r in reqs]


def timed_run(eng, reqs, **kw):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    done = eng.run(reqs, **kw)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t


def phase_tiers(model, params) -> dict:
    """(a) Tiers (1.0, 0.5) at once on one paged, prefix-sharing engine (the 16
    requests, every other one at tier 1): each tier's greedy tokens equal a
    single-tier engine's on ``slice_rank(params, f)`` bit for bit; every tier-1
    factor shares its storage with the tier-0 one; lowrank_matmul ran at the
    tier-1 ranks and no factored apply fell to two GEMMs; the
    certificates are finite, tier 0's 0 and tier 1's no smaller."""
    import math

    from repro_torch.core.lowrank import is_lowrank, slice_rank
    from repro_torch.kernels import lowrank_matmul
    from repro_torch.runtime import dispatch
    from repro_torch.serving import Engine

    reqs = engine_requests(model.cfg)
    for i, r in enumerate(reqs):
        r.tier = i % 2
    eng = Engine(model, params, **ENGINE, share_prefix=True, tiers=TIERS, tier_q=2)
    shared = []

    def walk(a, b):
        if is_lowrank(a):
            shared.extend(a[n].untyped_storage().data_ptr() == b[n].untyped_storage().data_ptr() for n in "ab")
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])

    walk(eng._tier_params[1], params)
    tier1 = {math.ceil(TIERS[1] * r) for r in stored_ranks(params)}
    if not shared or not all(shared):
        fail(f"tiers: {shared.count(False)} of {len(shared)} tier-1 factors do not share the stored storage")
    dispatch.reset_counters()
    lowrank_matmul.KERNEL.reset()
    _, dt = timed_run(eng, reqs)
    launches = lowrank_matmul.KERNEL.launches
    ranks = {s[3] for (op, path, s) in dispatch.counters() if op == "lowrank_matmul" and path == "fused"}
    two = {s for (op, path, s) in dispatch.counters() if op == "lowrank_matmul" and path == "two_gemm"}
    say(f"[tiers] mixed engine: {sum(len(r.tokens) for r in reqs)} tokens in {dt:.3f}s; lowrank_matmul launches "
        f"{launches} at ranks {sorted(ranks)}; two_gemm calls: {len(two)}; "
        f"graphs captured {sorted(eng._graphs)}")
    if launches <= 0 or not tier1 <= ranks or two:
        fail(f"tiers: lowrank_matmul at ranks {sorted(ranks)} (tier 1's {sorted(tier1)} expected), two_gemm {two}")
    out = {"mixed_s": dt, "launches": launches}
    for t, f in enumerate(TIERS):
        mine = [r for r in reqs if r.tier == t]
        solo = Engine(model, slice_rank(params, f), **ENGINE, share_prefix=True)
        done, dt = timed_run(solo, fresh(mine))
        n_tok = sum(len(r.tokens) for r in done)
        equal = sum(a.tokens == b.tokens for a, b in zip(mine, sorted(done, key=lambda r: r.uid)))
        cert = eng.tier_certificates[t]
        say(f"[tiers] tier {t} (rank fraction {f}): {equal}/{len(mine)} requests equal the single-tier engine's "
            f"tokens; single-tier {n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s (host clock); certificate "
            f"||tail||_2 {cert.spectral_error:.4e}, bound {cert.prob_deviation_bound:.4e}")
        if equal != len(mine) or any(r.tier != t or r.certificate is not cert for r in mine):
            fail(f"tiers: tier {t}: {equal}/{len(mine)} equal the single-tier run's tokens")
        out[f"tier{t}"] = {"equal": equal, "tok_s": n_tok / dt, "bound": cert.prob_deviation_bound,
                           "spectral_error": cert.spectral_error}
    c0, c1 = eng.tier_certificates
    if not (math.isfinite(c1.prob_deviation_bound) and c0.prob_deviation_bound == 0.0
            and c1.prob_deviation_bound >= c0.prob_deviation_bound):
        fail(f"tiers: certificates {c0} / {c1}")
    out["cost"] = tier_cost(model, params)
    return out


def tier_cost(model, params, blocks: int = 6) -> dict:
    """What serving two tiers at once costs against one (informational): a
    step with slots on both tiers runs one decode block a tier over all the
    slots.  End to end: the 16 requests (every other one at tier 1) on a
    two-tier engine and, all at tier 0, on a single-tier engine, each
    engine warmed by one run, then timed single, two, two, single (host
    clock; no prefix sharing, so no run reuses another's pages).  Per
    block: 8 slots decoding (4 a tier on the two-tier engine), host time of
    ``blocks`` steps and the profiled device time of one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, Request

    base = engine_requests(model.cfg)
    engines = {"single": Engine(model, params, **ENGINE), "two": Engine(model, params, **ENGINE, tiers=TIERS)}
    tiers = {"single": [0] * len(base), "two": [i % 2 for i in range(len(base))]}

    def batch(name):
        reqs = fresh(base)
        for r, t in zip(reqs, tiers[name]):
            r.tier = t
        return reqs

    for name, eng in engines.items():
        eng.run(batch(name))  # the warm-up run: captures, allocator
    runs = {"single": [], "two": []}
    for name in ("single", "two", "two", "single"):
        done, dt = timed_run(engines[name], batch(name))
        runs[name].append(sum(len(r.tokens) for r in done) / dt)
    out = {f"{name}_tok_s": v for name, v in runs.items()}
    # as in phase 8: 64 + 256 tokens = 5 pages each, so all 8 requests fit the 40 pages
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, size=64) for _ in range(ENGINE["n_slots"])]
    for name in ("single", "two"):
        eng = Engine(model, params, **ENGINE, tiers=TIERS if name == "two" else None)
        for i, q in enumerate(prompts):
            eng.submit(Request(prompt=q, max_new_tokens=256, tier=tiers[name][i]))
        eng.step()
        eng.step()
        if eng.n_active != ENGINE["n_slots"]:
            fail(f"tier cost: {eng.n_active} of {ENGINE['n_slots']} slots active")
        torch.cuda.synchronize()
        tok0, t = eng.decoded_tokens, time.perf_counter()
        for _ in range(blocks):
            eng.step()
        wall = (time.perf_counter() - t) / blocks
        tok_s = (eng.decoded_tokens - tok0) / (wall * blocks)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
        out[f"{name}_step_host_ms"], out[f"{name}_step_device_ms"] = wall * 1e3, device_busy_ms(prof)
        out[f"{name}_step_tok_s"] = tok_s
    say(f"[tiers] cost of two tiers at once, {card_line()}: the {N_REQUESTS} requests at "
        f"{', '.join(f'{v:.1f}' for v in runs['two'])} tok/s on the two-tier engine (half at tier 1) against "
        f"{', '.join(f'{v:.1f}' for v in runs['single'])} tok/s on a single-tier one (host clock, runs alternated); "
        f"one step of {ENGINE['n_slots']} decoding slots: two-tier {out['two_step_host_ms']:.3f} ms host, "
        f"{out['two_step_device_ms']:.3f} ms device (profiler), {out['two_step_tok_s']:.1f} tok/s; single-tier "
        f"{out['single_step_host_ms']:.3f} ms host, {out['single_step_device_ms']:.3f} ms device, "
        f"{out['single_step_tok_s']:.1f} tok/s")
    return out


def stored_ranks(params) -> set:
    from repro_torch.core.lowrank import is_lowrank

    if is_lowrank(params):
        return {params["a"].shape[-1]}
    return set().union(*(stored_ranks(v) for v in params.values())) if isinstance(params, dict) else set()


def divergence(model, m32, params, p32, prompt, want, got, tag, extras=None):
    """Where a bf16 stream ``got`` first leaves the uninterrupted ``want``: the
    top-2 margin of the uninterrupted run's logits there (the kernels'
    teacher-forced bf16 forward of prompt + want) against the bf16 spread
    at that token (the plain versions' bf16 logits against their fp32 ones
    on the same tokens, max over that row alone, so only a flip that the
    rounding at that token explains passes).  Fails if the margin exceeds
    the spread.  ``extras``: the request's image or frames, unbatched."""
    import numpy as np
    import torch

    from repro_torch.runtime.dispatch import use_dispatch

    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(want[:-1], np.int64)])[None], device=model.device)
    batch = {"tokens": seq, **{k: torch.as_tensor(v[None], device=model.device) for k, v in (extras or {}).items()}}
    L = prompt.size
    logits = model.forward(params, batch)[0][0, L - 1:].float()
    with use_dispatch(backend="reference"):
        ref16 = model.forward(params, batch)[0][0, L - 1:].float()
        ref32 = m32.forward(p32, batch)[0][0, L - 1:].float()
    spread = float((ref16[j] - ref32[j]).abs().max())
    top = torch.topk(logits[j], 2)
    margin = float(top.values[0] - top.values[1])
    lead = float((ref16[j] - ref32[j])[top.indices].abs().sum())
    say(f"[{tag}] diverges at token {j} of {len(want)}: the uninterrupted run's top-2 margin there {margin:.4e}, "
        f"bf16 spread at that token {spread:.4e} (the two leading tokens' errors sum to {lead:.4e})")
    if margin > spread:
        fail(f"{tag}: a divergence at token {j} where the top-2 margin {margin:.4e} exceeds the bf16 spread "
             f"{spread:.4e}")
    return {"token": j, "margin": margin, "spread": spread, "lead_err": lead}


def phase_preempt(model, m32, params, p32, *, gen: int = PREEMPT_GEN, shares=(True, False), tag="preempt") -> dict:
    """(b) Preemption on a pool that holds one of two requests (page 64, 5
    pages, prompts of 200 and 210 tokens, ``gen`` new each): the priority-1
    request arrives after three decode blocks of the first; with
    ``share_prefix`` in ``shares``.  Gates: one preemption, no page left;
    fp32: both streams equal the uninterrupted runs bit for bit; bf16: the
    count of equal streams, and a divergence only where the uninterrupted
    run's top-2 margin is within the bf16 spread.  A vlm or audio request
    carries its own image or frames (``SyntheticLM``'s, seed 3): a
    continuation that lost them fails the fp32 gate."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serving import Engine, Request

    data = SyntheticLM(model.cfg, batch=2, seq=max(PREEMPT_LENS), kind="serve", seed=3).at_step(0)
    prompts = [np.asarray(data["tokens"][i, :n], np.int64) for i, n in enumerate(PREEMPT_LENS)]
    extras = [{k: v[i] for k, v in data.items() if k != "tokens"} for i in range(2)]
    out = {}
    for dtype, m, p in (("fp32", m32, p32), ("bf16", model, params)):
        base = Engine(m, p, **PREEMPT)
        want = [base.run([Request(prompt=q, max_new_tokens=gen, extras=e)])[0].tokens
                for q, e in zip(prompts, extras)]
        for share in shares:
            eng = Engine(m, p, **PREEMPT, share_prefix=share, preempt=True)
            r0 = eng.submit(Request(prompt=prompts[0], max_new_tokens=gen, extras=extras[0]))
            for _ in range(3):
                eng.step()
            emitted = len(r0.tokens)
            r1 = eng.submit(Request(prompt=prompts[1], max_new_tokens=gen, priority=1, extras=extras[1]))
            while eng.has_work:
                eng.step()
            equal = [r0.tokens == want[0], r1.tokens == want[1]]
            say(f"[{tag}] {dtype} share_prefix={share}: preempted after {emitted} tokens; preemptions "
                f"{eng.preemptions}, pages in use at the end {eng.pages_in_use}, shared admissions "
                f"{eng.shared_admissions}; streams equal to the uninterrupted runs {equal}")
            if eng.preemptions != 1 or eng.pages_in_use != 0 or r0.status != "ok" or len(r0.tokens) != gen:
                fail(f"{tag} {dtype} share={share}: preemptions {eng.preemptions}, pages {eng.pages_in_use}, "
                     f"status {r0.status}, {len(r0.tokens)} tokens")
            res = {"emitted_before": emitted, "equal": sum(equal)}
            if dtype == "fp32" and not all(equal):
                fail(f"{tag} fp32 share={share}: streams equal {equal}")
            for i, ok in enumerate(equal):
                if not ok:
                    res[f"stream{i}"] = divergence(model, m32, params, p32, prompts[i], want[i],
                                                   (r0, r1)[i].tokens, f"{tag} bf16 share={share} stream {i}",
                                                   extras[i])
            out[f"{dtype}_share{int(share)}"] = res
    return out


def phase_overload(model, params) -> dict:
    """(c) The 16 requests on a two-tier engine under an admission policy
    (degrade to tier 1 below half the pages free; every odd uid has an
    800 ms deadline; every request accepts tier 1), a page-denial window
    (steps 6-12) and 1 s slow steps (10-12) watched by a StepWatchdog.
    Gates: ok + shed + error = 16, shed > 0, each shed request's
    RejectedOverload, degraded admissions > 0, each degraded request's
    tokens the single-tier tier-1 run's, the slow steps flagged."""
    from collections import Counter

    from repro_torch.core.lowrank import slice_rank
    from repro_torch.serving import AdmissionPolicy, Engine, FaultInjector, StepWatchdog

    reqs = engine_requests(model.cfg)
    for i, r in enumerate(reqs):
        r.min_tier, r.deadline_ms = 1, (800.0 if i % 2 else None)
    # a slow step is flagged above 3 x the median of the steps before it (admissions and two-tier
    # blocks, ~0.1 s each on an H100): 1 s clears that for every slow step, where 400 ms left the
    # third (which does no other work) near 3 x, flagged or not by the host's speed
    inj = FaultInjector(deny_pages=(6, 13), slow_steps=(10, 13), slow_ms=1000.0)
    events = Counter()
    eng = Engine(model, params, **ENGINE, tiers=TIERS, tier_q=2, injector=inj,
                 admission=AdmissionPolicy(n_tiers=2, degrade_free_frac=0.5),
                 watchdog=StepWatchdog(straggler_factor=3.0), on_event=lambda k, f: events.update([k]))
    done, dt = timed_run(eng, reqs)
    by = Counter(r.status for r in done)
    shed = [r for r in done if r.status == "shed"]
    degraded = [r for r in done if r.status == "ok" and r.tier == 1]
    say(f"[overload] {len(done)} of {len(reqs)} requests in {dt:.3f}s: {dict(by)}; degraded admissions "
        f"{eng.degraded_admissions}; faults fired {inj.fired}; watchdog straggler steps "
        f"{eng.watchdog.straggler_steps} (median {eng.watchdog.median * 1e3:.1f} ms); events {dict(events)}")
    for r in shed:
        say(f"[overload]   shed uid {r.uid}: {r.rejected}")
    if len(done) != len(reqs) or by["ok"] + by["shed"] + by["error"] != len(reqs) or not shed:
        fail(f"overload: statuses {dict(by)} of {len(reqs)} (ok + shed + error = submitted, shed > 0)")
    if any(r.rejected is None or r.rejected.reason != "deadline-expired" or r.rejected.uid != r.uid for r in shed):
        fail("overload: a shed request without its RejectedOverload")
    if eng.degraded_admissions <= 0 or not degraded:
        fail(f"overload: {eng.degraded_admissions} degraded admissions")
    if not {10, 11, 12} <= set(eng.watchdog.straggler_steps) or eng.straggler_flags != len(eng.watchdog.straggler_steps):
        fail(f"overload: the watchdog flagged steps {eng.watchdog.straggler_steps}, not the slow steps 10-12")
    solo = Engine(model, slice_rank(params, TIERS[1]), **ENGINE)
    again = sorted(solo.run(fresh(degraded)), key=lambda r: r.uid)
    equal = sum(a.tokens == b.tokens for a, b in zip(degraded, again))
    say(f"[overload] degraded requests equal to the single-tier tier-1 run's tokens: {equal}/{len(degraded)}")
    if equal != len(degraded):
        fail(f"overload: {equal}/{len(degraded)} degraded requests equal the tier-1 run's tokens")
    return {"statuses": dict(by), "degraded": eng.degraded_admissions, "stragglers": eng.watchdog.straggler_steps,
            "events": dict(events), "s": dt}


def first_admitted(cfg, reqs) -> list:
    """The requests the engine admits at its first step (FIFO, slots and pages
    permitting), in order."""
    pages, out = 0, []
    for r in reqs[: ENGINE["n_slots"]]:
        need = -(-(r.prompt.size + r.max_new_tokens) // ENGINE["page_size"])
        if pages + need > ENGINE["kv_pages"]:
            break
        pages += need
        out.append(r)
    return out


def phase_nan(model, params) -> tuple:
    """(d) nan_logits under the captured block: the 16 requests on an engine
    with an unarmed injector, then with one armed at the third block of a
    request admitted at the first step and prefilled whole.  Gates: exactly
    that uid errors, with the clean run's tokens before the fault; every
    other request's tokens are the clean run's; both engines replayed their
    graph and captured the same number of graphs."""
    from repro_torch.serving import Engine, FaultInjector

    reqs = engine_requests(model.cfg)
    clean_eng = Engine(model, params, **ENGINE, injector=FaultInjector())
    clean = {r.uid: r.tokens for r in clean_eng.run(reqs)}
    cand = [r for r in first_admitted(model.cfg, reqs) if r.prompt.size <= ENGINE["prefill_chunk"]]
    if not cand:
        fail("nan: no request is prefilled whole at the first step")
    victim = max(cand, key=lambda r: r.max_new_tokens)
    at = 2 * ENGINE["decode_block"] + 3  # the third block's fourth step
    if victim.max_new_tokens <= at + 2:
        fail(f"nan: uid {victim.uid} ends before step {at}")
    inj = FaultInjector(nan_logits=(victim.uid, at))
    eng = Engine(model, params, **ENGINE, injector=inj)
    by = {r.uid: r for r in eng.run(fresh(reqs))}
    bad = by[victim.uid]
    others = sum(by[u].tokens == clean[u] for u in by if u != victim.uid)
    say(f"[nan] poisoned uid {victim.uid} at decode step {at}: fired {inj.fired}; status {bad.status} "
        f"({bad.error}) after {len(bad.tokens)} tokens, a prefix of the clean run's: "
        f"{bad.tokens == clean[victim.uid][: len(bad.tokens)]}; others equal to the clean run "
        f"{others}/{len(by) - 1}; quarantined {eng.quarantined}; graphs captured armed {len(eng._graphs)} / "
        f"unarmed {len(clean_eng._graphs)}; replays {eng.graph_replays} / {clean_eng.graph_replays}")
    errored = [u for u, r in by.items() if r.status == "error"]
    if inj.fired.get("nan_logits") != 1 or errored != [victim.uid] or others != len(by) - 1:
        fail(f"nan: errored {errored}, others equal {others}/{len(by) - 1}, fired {inj.fired}")
    if bad.tokens != clean[victim.uid][: len(bad.tokens)] or not 0 < len(bad.tokens) < victim.max_new_tokens:
        fail("nan: the poisoned request's tokens before the fault differ from the clean run's")
    if (len(eng._graphs) != len(clean_eng._graphs) or eng.graph_replays <= 0 or clean_eng.graph_replays <= 0
            or not eng.cuda_graph):
        fail(f"nan: graphs {len(eng._graphs)} armed vs {len(clean_eng._graphs)} unarmed, replays {eng.graph_replays}")
    return clean, {"victim": victim.uid, "at": at, "tokens_before": len(bad.tokens), "graphs": len(eng._graphs),
                   "replays": eng.graph_replays}


def phase_drain(model, m32, params, p32, clean) -> dict:
    """(e) ``run(stop=...)`` after two decode blocks sheds the queue with
    "shutdown" and finishes the in-flight requests with the clean run's
    tokens (bf16); then ``export_inflight`` and ``take_queue`` after three
    steps, resubmitted to a second engine, give the uninterrupted tokens
    (fp32, bit for bit; bf16 reported, a divergence held to the margin
    rule of (b))."""
    from repro_torch.serving import Engine

    eng = Engine(model, params, **ENGINE)
    done = eng.run(engine_requests(model.cfg), stop=lambda: eng.steps >= 2 * ENGINE["decode_block"])
    ok = [r for r in done if r.status == "ok"]
    shed = [r for r in done if r.status == "shed"]
    equal = sum(r.tokens == clean[r.uid] for r in ok)
    say(f"[drain] stop after 2 blocks: {len(ok)} finished ({equal} with the clean run's tokens), {len(shed)} shed "
        f"({sorted({r.rejected.reason for r in shed})}); pages in use {eng.pages_in_use}")
    if (not shed or len(ok) + len(shed) != N_REQUESTS or equal != len(ok) or eng.pages_in_use
            or any(r.rejected.reason != "shutdown" for r in shed)):
        fail(f"drain: {len(ok)} ok ({equal} equal), {len(shed)} shed of {N_REQUESTS}")
    out = {"drain_ok": len(ok), "drain_shed": len(shed)}
    for dtype, m, p in (("fp32", m32, p32), ("bf16", model, params)):
        reqs = engine_requests(model.cfg)[:6]
        want = [r.tokens for r in sorted(Engine(m, p, **ENGINE).run(fresh(reqs)), key=lambda r: r.uid)]
        first = Engine(m, p, **ENGINE)
        for r in reqs:
            first.submit(r)
        for _ in range(3):
            first.step()
        queued = first.take_queue()
        moved = first.export_inflight()
        second = Engine(m, p, **ENGINE)
        for r in moved + queued:
            second.submit(r)
        while second.has_work:
            second.step()
        equal = [r.tokens == w for r, w in zip(reqs, want)]  # resubmission renumbers uids
        say(f"[export] {dtype}: {first.exported} exported after 3 steps ({sum(len(r.tokens) for r in reqs)} tokens "
            f"at the end), {len(queued)} queued moved; pages left on the first engine {first.pages_in_use}; "
            f"streams equal to the uninterrupted runs {sum(equal)}/{len(reqs)}")
        if first.pages_in_use or first.has_work or any(r.status != "ok" for r in reqs):
            fail(f"export {dtype}: the first engine kept work or pages, or a request failed")
        if dtype == "fp32" and not all(equal):
            fail(f"export fp32: streams equal {equal}")
        for i, (r, e) in enumerate(zip(reqs, equal)):
            if not e:
                divergence(model, m32, params, p32, r.prompt, want[i], r.tokens, f"export bf16 request {i}")
        out[f"export_{dtype}_equal"] = sum(equal)
    return out


def phase_stage4(model, params) -> dict:
    """Phase 21: engine stage 4 on the q = 4 llama3.2-1b, items (a)-(e)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.models.model import build_model

    t = time.perf_counter()
    out = {"tiers": phase_tiers(model, params)}
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"), device=model.device)
    p32 = params_fp32(params)
    out["preempt"] = phase_preempt(model, m32, params, p32)
    out["overload"] = phase_overload(model, params)
    clean, out["nan"] = phase_nan(model, params)
    out.update(phase_drain(model, m32, params, p32, clean))
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t
    say("[stage4] phase 21 " + json.dumps(out))
    return out


# --------------------------------------------------------------------------- #
# phase 26: the replicated cluster at full width
# --------------------------------------------------------------------------- #
# each replica: 4 slots, page 64, max_len 640, 20 pages (half of its flat pool), prefill chunk 256,
# decode block 8, prefix sharing, the CUDA-graph block
CLUSTER_ENGINE = dict(n_slots=4, max_len=640, page_size=64, kv_pages=20, prefill_chunk=256, decode_block=8,
                      share_prefix=True)
CLUSTER_KILL = (0, 3)  # replica 0 dies at its third step
# the hang case's deadline floor: two replicas' concurrent steps ran to ~0.4 s on an H100 (their host work
# shares one interpreter), and a floor of 250 ms declared a healthy replica dead
CLUSTER_HEARTBEAT_MS = 1000.0
CLUSTER_KILL_HEARTBEAT_MS = 60000.0  # the kill and no-fault cases: never the death signal
CLUSTER_HANG_X = 4.0  # a hang of this many times the replica's adapted deadline
# (iii) arms the hang, and tightens the heartbeat to CLUSTER_HEARTBEAT_MS, only once replica 0 has stepped
# this many times in a row under the adapted deadline: a natural stall at the trace's start (0.44 s steps
# in one full run on the H100) once declared it dead before its armed hang
CLUSTER_STEADY_STEPS = 3
CLUSTER_SLOW_S, CLUSTER_STRAGGLER_S = 1.5, 1.0  # (iv): one slow engine step, and the death floor it clears


def cluster_factory(model, params, pool=None, **kw):
    """``factory(rid)`` of the cluster: an engine of CLUSTER_ENGINE (and
    ``kw``) on the one shared model and params.  ``pool``: warm engines of
    earlier clusters, handed out first by replica id with their prefix cache
    (whose pages would turn a repeated prompt into a shared prefix, another
    compute path), counters and event sink reset."""
    from repro_torch.serving import Engine

    def make(rid):
        if pool and rid in pool:
            eng = pool.pop(rid)
            eng.reset_prefix_cache()
            eng.reset_counters()
            eng.on_event = eng.scheduler.on_event = None
            return eng
        return Engine(model, params, **{**CLUSTER_ENGINE, **kw})

    return make


def cluster_requests(cfg, n: int, seed: int, prompts=(32, 256), gens=(16, 64)):
    """``n`` SyntheticLM prompts (seed ``seed``) of ``prompts`` tokens, ``gens`` new ones each."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompts[0], prompts[1] + 1, size=n)
    gen = rng.integers(gens[0], gens[1] + 1, size=n)
    toks = SyntheticLM(cfg, batch=n, seq=prompts[1], kind="serve", seed=seed).at_step(0)["tokens"]
    return [Request(prompt=toks[i, : lens[i]], max_new_tokens=int(gen[i])) for i in range(n)]


def cluster_run(clu, reqs, label, libs, **kw):
    """One ``Cluster.run`` over ``reqs``, the launch and dispatch counts reset
    just before it and read just after (the replica threads idle by then);
    returns (finished roots, seconds, launches)."""
    import torch

    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.runtime import dispatch

    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    dispatch.reset_counters()
    ALIGN_COPIES.reset()
    t = time.perf_counter()
    done = clu.run(reqs, timeout_s=300.0, **kw)
    dt = time.perf_counter() - t
    launches = {n: lib.launches for n, lib in libs.items()}
    no_align_copies(f"the cluster run ({label})")
    n_tok = sum(len(r.tokens) for r in done)
    st = clu.stats()
    engines = [r.eng for r in clu.replicas]
    say(f"[cluster] {label}: {len(done)} roots, {n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s; "
        f"failovers {st['failovers']} (prefix match {st['failovers_prefix_match']}), deaths {st['replica_deaths']}, "
        f"heartbeat misses {st['heartbeat_misses']}, rejoins {st['rejoins']}, exhausted {st['exhausted']}; per "
        f"replica (decode steps, graph replays, prefill chunks, capture s so far): "
        f"{[(e.steps, e.graph_replays, e.prefill_chunks, round(e.capture_seconds, 3)) for e in engines]}; "
        f"launches {launches}")
    return done, dt, launches


def cluster_replay(model, params, items) -> list:
    """Tokens an engine of the replicas' configuration that has seen none of
    them emits for each (prompt, max_new): the continuations a failover
    resumed, replayed.  One engine serves every replay (its block captured
    once), its prefix index emptied first."""
    from repro_torch.serving import Engine, Request

    eng = getattr(cluster_replay, "engine", None)
    if eng is None or eng.model is not model:
        eng = cluster_replay.engine = Engine(model, params, **CLUSTER_ENGINE)
    eng.reset_prefix_cache()
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in items]
    eng.run(reqs)
    if any(r.status != "ok" for r in reqs):
        fail("cluster: a replayed continuation did not finish")
    return [list(r.tokens) for r in reqs]


def cluster_streams(model, params, clu, reqs, refs, tag) -> dict:
    """The per-compute-path contract (tests/test_cluster.py's): every root ok
    with its token count; a root that never failed over equals the single
    replica's stream bit for bit; a failed-over root's credited prefix equals
    it, and each resumed tail equals a fresh engine serving that
    continuation.  On a failure, which rows differ and where, first."""
    import numpy as np

    bad = [i for i, r in enumerate(reqs) if r.status != "ok" or len(r.tokens) != r.max_new_tokens]
    if bad:
        fail(f"{tag}: roots {bad} did not finish ok with their token counts "
             f"({[(reqs[i].status, reqs[i].rejected) for i in bad]})")
    points = clu.stats()["resume_points"]
    unfailed = [i for i, r in enumerate(reqs) if not points.get(r.uid)]
    diverged = [(i, next(j for j, (a, b) in enumerate(zip(reqs[i].tokens, refs[i])) if a != b))
                for i in unfailed if list(reqs[i].tokens) != refs[i]]
    prefix_bad, items, where = [], [], []
    for i, r in enumerate(reqs):
        splits = points.get(r.uid) or []
        got = list(r.tokens)
        if splits and got[: splits[0]] != refs[i][: splits[0]]:
            prefix_bad.append((i, splits[0]))
        bounds = list(splits) + [len(got)]
        for j, k in enumerate(splits):
            if bounds[j + 1] > k:  # the resume emitted something
                items.append((np.concatenate([r.prompt, np.asarray(got[:k], np.int64)]), r.max_new_tokens - k))
                where.append((i, k, bounds[j + 1]))
    tails = cluster_replay(model, params, items) if items else []
    tail_bad = [(i, k) for (i, k, end), want in zip(where, tails) if list(reqs[i].tokens)[k:end] != want[: end - k]]
    out = {"roots": len(reqs), "failed_over": len(reqs) - len(unfailed), "resumes_replayed": len(items),
           "unfailed_equal": len(unfailed) - len(diverged), "prefix_equal": len(reqs) - len(unfailed) - len(prefix_bad),
           "tails_equal": len(items) - len(tail_bad)}
    say(f"[{tag}] tokens per compute path: {json.dumps(out)}; resume points {points}")
    if diverged or prefix_bad or tail_bad:
        say(f"[{tag}] diverging rows (request, first differing token): unfailed {diverged}, credited prefixes "
            f"{prefix_bad}, resumed tails (request, split) {tail_bad}")
        fail(f"{tag}: the bitwise per-path contract failed (unfailed {diverged}, prefixes {prefix_bad}, "
             f"tails {tail_bad})")
    return out


def cluster_warm(clu, cfg, tag) -> list:
    """Warm every replica in its own thread, then time steady steps for the
    adaptive heartbeat deadline: short requests through the cluster (two a
    replica; a thread's first step on the card pays its per-thread CUDA set-up,
    which the cold grace covers, but a deadline from steps timed on another
    thread would not), then fresh watchdogs timing one more request a
    replica.  Returns each replica's first step seconds in its thread."""
    from repro_torch.serving import StepWatchdog

    n = len(clu.replicas)
    seen = [len(r.eng.watchdog.durations) if r.eng.watchdog is not None else 0 for r in clu.replicas]
    clu.run(cluster_requests(cfg, 2 * n, seed=90, prompts=(16, 48), gens=(8, 16)), timeout_s=300.0)
    first = [r.eng.watchdog.durations[k] if len(r.eng.watchdog.durations) > k else None
             for r, k in zip(clu.replicas, seen)]
    for r in clu.replicas:
        r.eng.watchdog = StepWatchdog()  # the replica thread reads it only inside a step; it is idle
    clu.run(cluster_requests(cfg, n, seed=91, prompts=(16, 48), gens=(24, 24)), timeout_s=300.0)
    say(f"[cluster] {tag} warm-up: each replica's first step in its own thread {first} s; steady step medians "
        f"{[round(r.eng.watchdog.median * 1e3, 2) for r in clu.replicas]} ms")
    return first


def cluster_events(path) -> list:
    events = [json.loads(line) for line in open(path, encoding="utf-8")]
    if any(not isinstance(e.get("t_ms"), float) or "event" not in e for e in events):
        fail(f"cluster: an event line of {path} lacks t_ms or event")
    return events


def cluster_dead_errors(clu, tag) -> list:
    """Each dead replica's ``step_error``: only the injector's host-side
    faults (ReplicaKilled, or none raised: a hang) may have killed one; a
    real device fault would have been hidden behind a failover."""
    from repro_torch.runtime.fault_tolerance import ReplicaKilled

    errs = []
    for rep in clu.replicas:
        with rep.health_lock:
            err = rep.step_error
        errs.append(None if err is None else f"{type(err).__name__}: {err}")
        if err is not None and not isinstance(err, ReplicaKilled):
            fail(f"{tag}: replica {rep.id} died of {type(err).__name__}: {err} (not an injected fault)")
    return errs


def phase_cluster(model, params) -> dict:
    """Phase 26: the replicated cluster (``serving/cluster.py``) on the q = 4
    llama3.2-1b, two replicas of CLUSTER_ENGINE sharing its one set of
    weights, each stepped by its own thread on its own CUDA stream, over
    phase 7's 16 requests.  The reference of (e) is a cluster of one
    replica (one engine of the replicas' configuration serving the trace);
    its time against two replicas' (both warmed in their own threads first)
    is reported, not gated, with each replica's first step in a new thread.
    (i) No fault: every root ok, tokens bit for bit the single replica's;
    lowrank_matmul, paged_decode_attention and flash_attention launched.
    (ii) kill_replica (0, 3): one death of the injected ReplicaKilled,
    failovers, the per-path token contract; then restart_replica(0) while
    replica 1 serves four more requests, probation, rejoin, two more
    requests routed after it (the restarted engine captures its graph while
    replica 1 serves); graph replays > 0 on every engine, the restarted one
    among them; the event log holds the life-cycle events.  (iii) After a
    warm-up in the replicas' threads, a hang of 4 x the replicas' adapted
    deadline at replica 0's third step: one heartbeat miss, failover, every
    root ok by the contract, the hung replica drains and rejoins.  (iv) A
    cluster of backend "reference" engines, warmed likewise, replica 0 dying
    of one 1.5 s step (the watchdog's straggler path, above a 1 s floor) and
    its thread draining it (export_inflight's rewrites): no kernel launched
    or captured.  (v) ``launch/serve.py --reduced --replicas 2
    --event-log`` in-process: every request served, the event lines parse,
    each admission's degrade event tagged with its replica."""
    t_phase = time.perf_counter()
    live = []  # every cluster made here, closed however the phase ends (fail() raises SystemExit)
    try:
        out = _phase_cluster(model, params, live)
    finally:
        for clu in live:
            clu.close()
        if getattr(cluster_replay, "engine", None) is not None:
            cluster_replay.engine.close()
            cluster_replay.engine = None
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _phase_cluster(model, params, live) -> dict:
    import os

    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.dispatch import DispatchConfig
    from repro_torch.serving import Cluster, EventLog, FailoverBudget, FaultInjector

    libs = engine_libs()
    cfg = model.cfg
    trace = lambda: engine_requests(cfg)  # noqa: E731
    out_dir = os.path.join(HERE, "build", "cluster")  # the event logs (build/ is not committed)
    os.makedirs(out_dir, exist_ok=True)
    budget = FailoverBudget(max_failovers=3, base_ms=10.0)

    def cluster(n, pool=None, **kw):
        kw.setdefault("heartbeat_ms", CLUSTER_KILL_HEARTBEAT_MS)
        clu = Cluster(cluster_factory(model, params, pool, **kw.pop("engine_kw", {})), n, budget=budget,
                      probation_s=0.05, straggler_min_s=1e9, **kw)
        live.append(clu)
        return clu

    def log_at(name):
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            os.remove(path)
        return path, EventLog(path)

    parts, t_part = {}, time.perf_counter()
    # the reference: one replica serving the trace, warm (its thread set up, its graph captured)
    one = cluster(1)
    first = {"one": cluster_warm(one, cfg, "one replica")}
    ref_reqs = trace()
    _, t_one, _ = cluster_run(one, ref_reqs, "one replica (the reference)", libs)
    one.close()
    refs = [list(r.tokens) for r in ref_reqs]
    if any(r.status != "ok" or len(r.tokens) != r.max_new_tokens for r in ref_reqs):
        fail("cluster: the single replica did not finish every request")
    pool = {0: one.replicas[0].eng}
    parts["one"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (i) two replicas, no fault, warm likewise
    clu = cluster(2, pool)
    first["two"] = cluster_warm(clu, cfg, "(i) two replicas")
    reqs = trace()
    _, t_two, launches = cluster_run(clu, reqs, "(i) two replicas, no fault", libs)
    say("[cluster] (i) dispatch table (graph calls counted per replay):")
    for line in dispatch.format_counters().splitlines():
        say(f"[cluster]   {line}")
    # informational: the trace once more with the interpreter's thread switch interval at 0.2 ms
    # (default 5 ms): the replicas' host work shares one interpreter lock
    interval = sys.getswitchinterval()
    sys.setswitchinterval(2e-4)
    try:
        again = trace()
        _, t_two_fast, _ = cluster_run(clu, again, "(i) two replicas again, switch interval 0.2 ms", libs)
    finally:
        sys.setswitchinterval(interval)
    clu.close()
    if [list(r.tokens) for r in again] != refs:
        fail("cluster (i): the second two-replica run's tokens differ from the single replica's")
    missing = [n for n in ("lowrank_matmul", "paged_decode_attention", "flash_attention") if launches[n] <= 0]
    if missing:
        fail(f"cluster (i): kernels never launched: {missing}")
    out = {"one_replica_s": t_one, "two_replicas_s": t_two, "two_vs_one": t_one / t_two,
           "two_replicas_switch_0p2ms_s": t_two_fast, "first_step_s": first,
           "launches_i": launches, "i": cluster_streams(model, params, clu, reqs, refs, "cluster (i)")}
    if clu.stats()["failovers"] or any(r.eng.graph_replays <= 0 or r.eng.steps <= 0 for r in clu.replicas):
        fail(f"cluster (i): failovers {clu.stats()['failovers']}, or a replica never stepped or replayed its graph")
    say(f"[cluster] warm, the same 16 requests: one replica {t_one:.3f}s, two {t_two:.3f}s: two run "
        f"{t_one / t_two:.2f}x one's rate; two again at a 0.2 ms switch interval {t_two_fast:.3f}s "
        f"({t_one / t_two_fast:.2f}x; host clock, not a gate)")
    pool = {r.id: r.eng for r in clu.replicas}
    parts["i"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (ii) kill, failover, restart while replica 1 serves, probation, rejoin, more requests
    log_path, log = log_at("cluster_events.jsonl")
    inj = FaultInjector(kill_replica=CLUSTER_KILL)
    clu = cluster(2, pool, injector=inj, event_log=log)
    reqs = trace()
    cluster_run(clu, reqs, "(ii) kill_replica (0, 3)", libs)
    errs = cluster_dead_errors(clu, "cluster (ii)")
    st = clu.stats()
    if inj.fired.get("kill_replica") != 1 or errs[0] is None or clu.replicas[0].thread_alive:
        fail(f"cluster (ii): the kill did not land (fired {inj.fired}, errors {errs})")
    if st["replica_deaths"] != 1 or st["failovers"] < 1 or st["exhausted"]:
        fail(f"cluster (ii): deaths {st['replica_deaths']}, failovers {st['failovers']}, exhausted {st['exhausted']}")
    out["ii"] = cluster_streams(model, params, clu, reqs, refs, "cluster (ii)")
    if out["ii"]["failed_over"] < 1:
        fail("cluster (ii): the kill failed no root over")
    inj.kill_replica = None
    survivor = clu.replicas[1].eng
    more = cluster_requests(cfg, 4, seed=31, gens=(48, 64))
    late = cluster_requests(cfg, 2, seed=32, gens=(16, 32))
    state = {"restart_active": None, "late": False}

    def during():  # polled on the monitor thread by Cluster.run
        if state["restart_active"] is None and survivor.n_active > 0:
            state["restart_active"] = survivor.n_active
            clu.restart_replica(0)  # replica 1 is serving: its engine is mid-run
        elif state["restart_active"] is not None and not state["late"] and clu.replicas[0].state == "healthy":
            for r in late:
                clu.submit(r)
            state["late"] = True
        return False

    cluster_run(clu, more, "(ii) restart while replica 1 serves, then 2 more", libs, stop=during)
    if not state["late"]:  # replica 1 finished before the rejoin: route the two now
        cluster_run(clu, late, "(ii) 2 more after the rejoin", libs)
    clu.close()
    log.close()
    restarted = clu.replicas[0].eng
    say(f"[cluster] (ii) restarted replica 0 while replica 1 had {state['restart_active']} active slots; graph "
        f"replays per engine {[r.eng.graph_replays for r in clu.replicas]}; rejoins {clu.stats()['rejoins']}")
    if state["restart_active"] is None or clu.stats()["rejoins"] != 1 or restarted.graph_replays <= 0:
        fail(f"cluster (ii): restart while serving {state['restart_active']}, rejoins {clu.stats()['rejoins']}, "
             f"the restarted engine's graph replays {restarted.graph_replays}")
    if survivor.graph_replays <= 0 or any(r.status != "ok" or len(r.tokens) != r.max_new_tokens for r in more + late):
        fail("cluster (ii): a request after the restart did not finish, or replica 1 never replayed its graph")
    want = cluster_replay(model, params, [(r.prompt, r.max_new_tokens) for r in more + late])
    if [list(r.tokens) for r in more + late] != want:
        fail("cluster (ii): the requests after the restart differ from a fresh engine's tokens")
    events = cluster_events(log_path)
    kinds = [e["event"] for e in events]
    need = ("replica_dead", "failover", "failover_resumed", "replica_restart", "replica_probation", "replica_rejoin")
    say(f"[cluster] (ii) event log {log_path}: {len(events)} lines, " + json.dumps(dict(Counter(kinds))))
    if any(k not in kinds for k in need) or next(e for e in events if e["event"] == "replica_dead")["replica"] != 0:
        fail(f"cluster (ii): the event log lacks life-cycle events ({sorted(set(kinds))})")
    out["ii"].update(events=dict(Counter(kinds)), step_errors=errs, restart_active=state["restart_active"],
                     graph_replays=[r.eng.graph_replays for r in clu.replicas])
    pool = {r.id: r.eng for r in clu.replicas}
    parts["ii"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (iii) hang: the heartbeat alone catches it.  The heartbeat stays at the kill cases' loose floor until
    # replica 0 has stepped CLUSTER_STEADY_STEPS times in a row under the adapted deadline; then (in its
    # own thread, before its next step) the floor drops to CLUSTER_HEARTBEAT_MS and the hang is armed at
    # that next step.  Every interval between replica 0's steps is kept, and printed at any miss
    log_path, log = log_at("cluster_hang_events.jsonl")
    steady = {"on": False, "times": [], "run": 0, "last": None, "armed": None}

    class SteadyHang(FaultInjector):
        def on_replica_step(self, replica, step_idx):
            if replica == 0 and steady["on"] and steady["armed"] is None:
                now = time.monotonic()
                if steady["last"] is not None:
                    steady["times"].append(now - steady["last"])
                    steady["run"] = steady["run"] + 1 if steady["times"][-1] < deadline else 0
                    if steady["run"] >= CLUSTER_STEADY_STEPS:
                        clu.heartbeat_ms = CLUSTER_HEARTBEAT_MS
                        self.hang_replica = steady["armed"] = (0, step_idx)
                steady["last"] = now
            super().on_replica_step(replica, step_idx)

    inj = SteadyHang()
    clu = cluster(2, pool, injector=inj, event_log=log)
    first["iii"] = cluster_warm(clu, cfg, "(iii)")
    clu.heartbeat_ms = CLUSTER_HEARTBEAT_MS
    deadline = max(clu._deadline_s(r) for r in clu.replicas)
    inj.hang_s = CLUSTER_HANG_X * deadline
    clu.heartbeat_ms = CLUSTER_KILL_HEARTBEAT_MS
    steady["on"] = True  # the warm-up is over
    say(f"[cluster] (iii) adapted deadline {deadline:.3f}s; hang {inj.hang_s:.3f}s once replica 0 has stepped "
        f"{CLUSTER_STEADY_STEPS} times in a row under it")
    reqs = trace()
    cluster_run(clu, reqs, "(iii) hang_replica", libs)
    st = clu.stats()
    times = ", ".join(f"{t:.3f}" for t in steady["times"])
    armed = None if steady["armed"] is None else steady["armed"][1]
    say(f"[cluster] (iii) hang armed at replica 0's step {armed}; its step intervals before: [{times}]s")
    if inj.fired.get("hang_replica") != 1 or st["heartbeat_misses"] != 1 or st["replica_deaths"] != 1 \
            or st["failovers"] < 1 or st["exhausted"]:
        fail(f"cluster (iii): fired {inj.fired}, stats {st}; replica 0's step intervals before the hang "
             f"[{times}]s against the deadline {deadline:.3f}s")
    out["iii"] = cluster_streams(model, params, clu, reqs, refs, "cluster (iii)")
    cluster_rejoin(clu, 0, inj.hang_s + 30.0, "cluster (iii)")
    errs = cluster_dead_errors(clu, "cluster (iii)")
    clu.close()
    log.close()
    kinds = Counter(e["event"] for e in cluster_events(log_path))
    if errs[0] is not None or not {"replica_dead", "replica_drained", "replica_rejoin"} <= set(kinds):
        fail(f"cluster (iii): replica 0's error {errs[0]}, events {dict(kinds)}")
    out["iii"].update(deadline_s=deadline, hang_s=inj.hang_s, events=dict(kinds),
                      pages_after_drain=clu.replicas[0].eng.pages_in_use)
    for r in clu.replicas:
        r.eng.close()
    del pool

    # (iv) engines of backend "reference": nothing launches or is captured, the drain included.  Replica 0
    # dies of one slow step inside its engine (the watchdog's straggler path; the heartbeat floor of 60 s
    # never fires), and its thread drains it: export_inflight's rewrites run in the replica thread
    parts["iii"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    before = {n: lib.captured for n, lib in libs.items()}
    for lib in libs.values():
        lib.reset()
    slow = FaultInjector()
    ref_dcfg = DispatchConfig(backend="reference")
    clu = cluster(2, engine_kw={"dispatch": ref_dcfg})
    clu.replicas[0].eng.injector = slow
    first["iv"] = cluster_warm(clu, cfg, "(iv) backend reference")
    warm_launches = {n: lib.launches for n, lib in libs.items()}
    clu.straggler_min_s = CLUSTER_STRAGGLER_S
    at = clu.replicas[0].eng._step_idx + 3  # its thread is idle: the engine's step count is settled
    slow.slow_ms, slow.slow_steps = CLUSTER_SLOW_S * 1e3, (at, at + 1)
    # 40-64 new tokens: 5-8 decode blocks, so every request is still running at the slow third step
    reqs = cluster_requests(cfg, 6, seed=41, prompts=(32, 128), gens=(40, 64))
    cluster_run(clu, reqs, f"(iv) backend reference, one {CLUSTER_SLOW_S}s step on replica 0", libs)
    cluster_rejoin(clu, 0, 60.0, "cluster (iv)")
    cluster_dead_errors(clu, "cluster (iv)")
    clu.close()
    launched = {n: lib.launches + warm_launches[n] for n, lib in libs.items()}
    captured = {n: lib.captured - before[n] for n, lib in libs.items()}
    paths = sorted({(op, path) for op, path in dispatch.counters_by_path()})
    st = clu.stats()
    out["iv"] = {"launches": launched, "captured": captured, "paths": paths,
                 "stats": {k: st[k] for k in ("failovers", "heartbeat_misses", "replica_deaths", "rejoins")},
                 "straggler_flags": [r.eng.straggler_flags for r in clu.replicas],
                 "exported": sum(r.eng.exported for r in clu.replicas),
                 "graph_replays": [r.eng.graph_replays for r in clu.replicas]}
    say("[cluster] (iv) " + json.dumps(out["iv"]))
    if any(launched.values()) or any(captured.values()):
        fail(f"cluster (iv): the reference backend launched {launched} and captured {captured} kernel launches")
    if any(p not in ("reference", "two_gemm", "torch") for _, p in paths) or slow.fired.get("slow_step") != 1 \
            or st["heartbeat_misses"] or st["replica_deaths"] != 1 or out["iv"]["exported"] < 1 \
            or any(r.status != "ok" for r in reqs):
        fail(f"cluster (iv): paths {paths}, fired {slow.fired}, stats {st}, exported {out['iv']['exported']}, "
             f"statuses {[r.status for r in reqs]}")
    for r in clu.replicas:
        r.eng.close()
    parts["iv"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (v) the launcher in-process
    log_path = os.path.join(out_dir, "serve_events.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    done = serve_cli.main(["--arch", "llama3.2-1b", "--reduced", "--replicas", "2", "--max-failovers", "2",
                           "--heartbeat-ms", str(CLUSTER_KILL_HEARTBEAT_MS), "--event-log", log_path, "--batch", "8",
                           "--n-slots", "2", "--page-size", "16", "--prompt-len", "32", "--gen", "24",
                           "--compress-alpha", "0.3", "--tiers", "1.0,0.5", "--degrade-queue-depth", "1"])
    events = cluster_events(log_path)
    degrade = [e for e in events if e["event"] == "degrade"]
    say(f"[cluster] (v) launcher: {len(done)} requests {dict(Counter(r.status for r in done))}; {len(events)} event "
        f"lines, {len(degrade)} degrade, replicas {sorted({e.get('replica') for e in events})}")
    if len(done) != 8 or any(r.status != "ok" or len(r.tokens) != 24 for r in done) or len(degrade) != 8 \
            or {e.get("replica") for e in events} != {0, 1}:
        fail("cluster (v): the launcher's cluster run or its event log")
    out["v"] = {"requests": len(done), "events": len(events)}
    parts["v"] = time.perf_counter() - t_part
    out["parts_s"] = parts
    say(f"[cluster] phase 26 parts, seconds: {json.dumps(parts)}")
    return out


def cluster_rejoin(clu, rid, timeout_s, tag) -> None:
    """Poll the monitor until a hung replica's thread has drained and walked
    probation back to healthy."""
    t = time.monotonic()
    while time.monotonic() - t < timeout_s:
        clu.check_health()
        if clu.replicas[rid].state == "healthy":
            return
        time.sleep(0.01)
    fail(f"{tag}: replica {rid} never rejoined (state {clu.replicas[rid].state})")


# --------------------------------------------------------------------------- #
# phase 27: the examples' twins and kernels/ops.py
# --------------------------------------------------------------------------- #
def phase_examples() -> dict:
    """Phase 27: ``experiments.compress_and_serve`` at its defaults and
    ``experiments.continuous_serving`` plain and with ``--sessions``,
    through ``main(argv)`` on the card (their own assertions gate: the greedy
    request equals ``greedy_generate`` bit for bit, the captured paged block
    against the static path); then each ``kernels.ops`` function at one
    main-path shape against the same call under backend "reference", within
    phase 2's tolerances, its kernel's launch count rising."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.lowrank import lowrank_params
    from repro_torch.experiments import compress_and_serve, continuous_serving
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.runtime.dispatch import use_dispatch

    t_phase = time.perf_counter()
    out = {}
    t = time.perf_counter()
    res = compress_and_serve.main([])
    dense = res["dense_tokens"]
    runs = {q: {"ratio": r["ratio"], "agreement": r["agreement"]} for q, r in res["runs"].items()}
    if any(not 0.0 < r["ratio"] < 1.0 or not 0.0 <= r["agreement"] <= 1.0 or r["tokens"].shape != dense.shape
           for r in res["runs"].values()):
        fail(f"compress_and_serve: {runs}")
    out["compress_and_serve"] = {"runs": runs, "s": time.perf_counter() - t}
    for argv in ([], ["--sessions"]):
        t = time.perf_counter()
        res = continuous_serving.main(argv)  # raises if the greedy request leaves greedy_generate's tokens
        eng = res["engine"]
        bad = [r.uid for r in res["done"] if r.status != "ok" or len(r.tokens) != r.max_new_tokens]
        if bad or eng.graph_replays <= 0 or (argv and (len(res["turns"]) != 3 or any(
                r.prefill_skipped < 16 for r in res["turns"][1:]))):
            fail(f"continuous_serving {argv}: requests {bad} unfinished, graph replays {eng.graph_replays}, "
                 f"turns {[(r.prefill_skipped, r.status) for r in res['turns']]}")
        out["continuous_serving" + "".join(argv)] = {"requests": len(res["done"]), "graph_replays": eng.graph_replays,
                                                     "s": time.perf_counter() - t}

    libs = engine_libs()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2727)

    def rnd(shape, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(torch.bfloat16)

    w = lowrank_params(rnd((2048, 615)), rnd((615, 8192)))  # llama's w_gate at alpha 0.3
    ex = lowrank_params(rnd((16, 4096, 1229)), rnd((16, 1229, 6400)))  # phi3.5-moe's expert w_gate stack
    q, k, v = rnd((4, PROMPT, 32, 64)), rnd((4, PROMPT, 8, 64)), rnd((4, PROMPT, 8, 64))
    qd, kc, vc = rnd((4, 1, 32, 64)), rnd((4, 288, 8, 64)), rnd((4, 288, 8, 64))
    valid = (torch.arange(288, device=dev) < 257)[None, :].expand(4, -1).contiguous()
    x, dt = rnd((1, 512, 64, 64), scale=1.0), F.softplus(torch.randn((1, 512, 64), generator=gen, device=dev))
    Bm, Cm, A = rnd((1, 512, 64), scale=8.0), rnd((1, 512, 64), scale=8.0), -torch.linspace(1.0, 16.0, 64, device=dev)
    gemm, attn = gemm_tolerances()[torch.bfloat16], attention_tolerances()[torch.bfloat16]
    cases = [  # (name, kernel, call, tolerance)
        ("sketch_matmul W @ Y, 2048x8192 @ 8192x615", "sketch_matmul",
         lambda Y=aligned_rows(rnd((8192, 615))), W=rnd((2048, 8192)): ops.sketch_matmul(W, Y), gemm),
        ("lowrank_matmul x (4, 1, 2048), w_gate 2048x615x8192", "lowrank_matmul",
         lambda xx=rnd((4, 1, 2048)): ops.lowrank_matmul(xx, w["a"], w["b"]), gemm),
        ("lowrank_matmul stacked, 16 experts x C 128, 4096x1229x6400", "lowrank_matmul_batched",
         lambda xx=rnd((16, 128, 4096)): ops.lowrank_matmul(xx, ex["a"], ex["b"]), gemm),
        ("ssd_scan zamba2 (1, 512), 64 x 64, s 64, raw x̄, chunk 128", "ssd_scan",
         lambda: ops.ssd_scan(x, dt, Bm, Cm, A)[0], (1e-2, "phase 2's ssd_scan bf16 tolerance")),
        ("flash_attention (4, 256), 32/8 heads, hd 64, causal", "flash_attention",
         lambda: ops.flash_attention(q, k, v, causal=True), attn),
        ("decode_attention B 4, S 288, 32/8 heads, hd 64, 257 valid", "decode_attention",
         lambda: ops.decode_attention(qd, kc, vc, valid), attn),
    ]
    out["ops"] = {}
    for name, kernel, call, (rel, why) in cases:
        before = libs[kernel].launches
        got = call()
        torch.cuda.synchronize()
        rose = libs[kernel].launches - before
        with use_dispatch(backend="reference"):
            want = call()
        err, tol = float((got.float() - want.float()).abs().max()), rel * float(want.float().abs().max())
        ok = err <= tol and bool(torch.isfinite(got.float()).all()) and rose >= 1
        rec = {"name": f"ops.{name}", "kernel": kernel, "launches": rose, "max_abs_err": err, "tol": tol,
               "tol_reason": why, "ok": ok}
        say("[ops] " + json.dumps(rec))
        if not ok:
            fail(f"ops {name}: err {err:.3e} (tol {tol:.3e}), {kernel} launches {rose}")
        out["ops"][kernel] = {"max_abs_err": err, "tol": tol, "launches": rose}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


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
                  cost=kernel_cost.ssd_scan(Bq, L, nh, hd, s, x.element_size()),
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
              cost=kernel_cost.flash_attention(BATCH, PROMPT, PROMPT, H, KV, hd, q.element_size()), records=g1)
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
              cost=kernel_cost.decode_attention(Bq, S, H, KV, hd, q.element_size(), n_rows=n_rows), records=g1)
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
              cost=kernel_cost.paged_decode_attention(Bq, n_tbl, H, KV, hd, q.element_size(), n_rows=n_rows),
              records=g1)
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
    ssd_bound, ssd_by = bound(kernel_cost.ssd_scan(1, L, nh, hd, s, 2), "bfloat16")
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


# --------------------------------------------------------------------------- #
# phase 18: the paper on the card (Fig 4.1, Fig 4.2, Table 4.1, Theorem 3.2, the CLI)
# --------------------------------------------------------------------------- #
PAPER_TRIALS = 3
TABLE_RATIOS = (1.461, 1.101, 0.739, 0.380)  # the reference's, alpha 0.8, 0.6, 0.4, 0.2 (shapes only)
SKETCH_SYMBOL = re.compile(r"\bgemm_f32_kernel\b")  # the fp32 sketch GEMM's FMA tiles


def paper_counted(fn, runs: dict, run: str):
    """``fn()`` with the sketch and low-rank counts set to 0 just before it
    and read just after, into ``runs[run]``."""
    import torch

    from repro_torch.kernels import lowrank_matmul, sketch_matmul

    kernels = {"sketch_matmul": sketch_matmul.KERNEL, "lowrank_matmul": lowrank_matmul.KERNEL}
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    out = fn()
    torch.cuda.synchronize()
    runs[run] = {n: k.launches for n, k in kernels.items()}
    return out


def paper_error_gates(tag: str, rows) -> None:
    """At every k, err(q=4) < err(q=1); every error >= 0.99 (the power method
    is a lower bound, so an optimal error may read just under 1)."""
    for k in sorted({r["k"] for r in rows}):
        by_q = {r["q"]: r["normalized_error"] for r in rows if r["k"] == k}
        if not by_q[4] < by_q[1]:
            fail(f"{tag} k={k}: err(q=4) {by_q[4]:.4f} >= err(q=1) {by_q[1]:.4f}")
    low = [r for r in rows if not r["normalized_error"] >= 0.99]
    if low:
        fail(f"{tag}: normalized errors under 0.99: {low}")


def paper_sketch_gate(tag: str, rows, trials: int, launches: int) -> None:
    """sketch_matmul launched 2q times per RSI call (a warm-up and ``trials``
    timed calls a cell)."""
    want = sum((trials + 1) * 2 * r["q"] for r in rows)
    if launches != want:
        fail(f"{tag}: sketch_matmul launched {launches} times, want 2q per RSI call = {want}")


def paper_profile(W, k: int, q: int, calls: int = 2) -> dict:
    """RSI calls at (k, q) under torch.profiler (one warm-up step unrecorded,
    then ``calls`` recorded): device busy time a call, the sketch kernel's
    share and the largest other kernels, against the host time of a call
    with the profiler off."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import rsi

    gen = torch.Generator(device="cuda").manual_seed(3)
    rsi(W, k, q, generator=gen)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    rsi(W, k, q, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
        for _ in range(calls + 1):
            rsi(W, k, q, generator=gen)
            torch.cuda.synchronize()
            prof.step()
    rows = device_rows(prof, calls)
    if not rows:
        fail(f"the RSI profile at k={k} q={q} holds no CUDA event: its device-time split is not measured")
    busy = device_busy_ms(prof, calls)
    sketch_us = sum(us for us, _, key in rows if SKETCH_SYMBOL.search(key))
    sketch_n = sum(n for _, n, key in rows if SKETCH_SYMBOL.search(key))
    out = {"k": k, "q": q, "wall_ms": wall * 1e3, "device_busy_ms": busy, "sketch_ms": sketch_us / 1e3,
           "sketch_launches": sketch_n, "sketch_share": sketch_us / 1e3 / busy,
           "idle_share": max(0.0, 1 - busy / (wall * 1e3))}
    say(f"[paper] profile {json.dumps(out)}")
    for us, n, key in rows[:10]:
        say(f"[paper]   {us / 1e3:8.4f} ms  x{n:<4d} {key[:100]}")
    return out


def paper_kernel_checks(W, records: dict) -> None:
    """Phase 2's checks at phase 18's shapes, fp32: the sketch GEMM on Fig
    4.1's W (W @ Y and W^T @ X at k 50 and 200, the operands in the storage
    RSI gives them) and the low-rank kernel on Table 4.1's compressed fc1 at
    alpha 0.2 (rank 103) over the 2048 test rows.  Comparison launches: not
    counted on the paper's runs."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.kernels.sketch_matmul import sketch_matmul

    rel = gemm_tolerances()[torch.float32][0]
    why = "fp32 sums over up to 25088 terms in another order than cuBLAS"
    g = torch.Generator(device="cuda").manual_seed(21)
    C, D = W.shape
    for k in (50, 200):
        for trans in (False, True):
            Y = aligned_rows(torch.randn((C if trans else D, k), generator=g, device="cuda"))
            M_out = D if trans else C
            check("sketch_matmul", [M_out, Y.shape[0], k, "trans_a" if trans else "plain", "fig4_1"], torch.float32,
                  sketch_matmul(W, Y, trans_a=trans), ref.sketch_matmul_ref(W, Y, trans_a=trans), rel, why,
                  kernel_fn=lambda: sketch_matmul(W, Y, trans_a=trans),
                  plain_fn=lambda: ref.sketch_matmul_ref(W, Y, trans_a=trans),
                  library_fn=lambda: torch.matmul(W.T if trans else W, Y),
                  cost=kernel_cost.sketch_matmul(C, D, k, W.element_size(), trans_a=trans), records=records,
                  key=f"sketch_matmul fig4_1 k {k}" + (" trans_a" if trans else ""))
            del Y
    M, K, r, N = 2048, 512, 103, 512
    x = torch.randn((M, K), generator=g, device="cuda")
    A = aligned_rows(torch.randn((K, r), generator=g, device="cuda") / K**0.5)
    B = aligned_rows(torch.randn((r, N), generator=g, device="cuda") / r**0.5)
    check("lowrank_matmul", [M, K, r, N, "table4_1 fc1 alpha 0.2"], torch.float32, lowrank_matmul(x, A, B),
          ref.lowrank_matmul_ref(x, A, B), rel, why, kernel_fn=lambda: lowrank_matmul(x, A, B),
          plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B), library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
          cost=kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()), records=records,
          key="lowrank_matmul table4_1")


def phase_paper(runs: dict, records: dict) -> dict:
    """Phase 18: the paper's experiments on the card, through the port's
    entry points (``repro_torch.experiments``, ``launch/compress.py``), with
    the kernels (backend ``auto``)."""
    import contextlib
    import io

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (CompressionPolicy, certify_head, certify_tier, compress_tree, normalized_error,
                                  rsi, rsi_factors, rsi_flops, spectralize_params, synth_spectrum_matrix,
                                  vgg_like_spectrum)
    from repro_torch.core.lowrank import break_even_rank
    from repro_torch.experiments import fig4_1, fig4_2, table4_1
    from repro_torch.launch import compress as compress_cli
    from repro_torch.models.model import build_model
    from repro_torch.runtime.dispatch import use_dispatch

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    card = card_line()
    summary: dict = {"card": card}
    t_phase = time.perf_counter()

    # --- Fig 4.1 at the paper's 4096 x 25088, fp32 ---------------------------
    C, D = 4096, 25088
    s = vgg_like_spectrum(C, device="cuda")
    t = time.perf_counter()
    W = synth_spectrum_matrix(C, D, s, generator=gen(0), device="cuda")
    torch.cuda.synchronize()
    say(f"[paper] fig4_1 W {C}x{D} fp32 built in {time.perf_counter() - t:.1f}s ({card})")
    paper_kernel_checks(W, records)
    f41 = paper_counted(lambda: fig4_1.run(full=True, trials=PAPER_TRIALS, W=W), runs, "paper fig4_1")
    for r in f41["rows"]:
        say(f"[paper] fig4_1 k={r['k']} q={r['q']}: {r['seconds']:.6f} s, normalized error "
            f"{r['normalized_error']:.4f} (std {r['err_std']:.4f}), {r['flops'] / r['seconds'] / 1e12:.3f} "
            f"TFLOP/s (rsi_flops / seconds)")
    paper_error_gates("fig4_1", f41["rows"])
    paper_sketch_gate("fig4_1", f41["rows"], PAPER_TRIALS, runs["paper fig4_1"]["sketch_matmul"])
    # auto against reference at (200, 4), one Omega and one start vector
    omega = torch.randn((D, 200), generator=gen(5), device="cuda")
    v0 = torch.randn((D,), generator=gen(6), device="cuda")
    errs = {}
    for backend in ("auto", "reference"):
        with use_dispatch(backend=backend):
            res = rsi(W, 200, 4, omega=omega)
        errs[backend] = float(normalized_error(W, res.U, res.S, res.Vt, float(s[200]), v0=v0))
    rel = abs(errs["auto"] - errs["reference"]) / errs["reference"]
    say(f"[paper] fig4_1 k=200 q=4 one Omega: auto {errs['auto']:.6f}, reference {errs['reference']:.6f}, "
        f"relative difference {rel:.2e} (tolerance 1e-3)")
    if not rel <= 1e-3:
        fail(f"fig4_1 auto vs reference: relative difference {rel:.2e} > 1e-3")
    summary["fig4_1"] = {"rows": f41["rows"], "auto_vs_reference": errs,
                         "profile": [paper_profile(W, k, q) for k, q in ((50, 1), (50, 4), (200, 4))]}
    del W, omega
    torch.cuda.empty_cache()

    # --- Fig 4.2: ViT-B/32 FFN, 768 x 3072 ------------------------------------
    f42 = paper_counted(lambda: fig4_2.run(trials=PAPER_TRIALS), runs, "paper fig4_2")
    say(f"[paper] fig4_2 exact SVD (torch.linalg.svd on the card): {f42['svd_seconds']:.6f} s")
    for r in f42["rows"]:
        say(f"[paper] fig4_2 k={r['k']} q={r['q']}: {r['seconds']:.6f} s, normalized error "
            f"{r['normalized_error']:.4f}, svd_speedup {r['svd_speedup']:.2f}x")
    paper_error_gates("fig4_2", f42["rows"])
    paper_sketch_gate("fig4_2", f42["rows"], PAPER_TRIALS, runs["paper fig4_2"]["sketch_matmul"])
    summary["fig4_2"] = {"svd_seconds": f42["svd_seconds"], "rows": f42["rows"]}

    # --- Table 4.1: the whole grid ---------------------------------------------
    t = time.perf_counter()
    t41 = paper_counted(lambda: table4_1.run(), runs, "paper table4_1")
    b = t41["baseline"]
    say(f"[paper] table4_1 baseline top1 {b['top1']:.4f} top5 {b['top5']:.4f} "
        f"(train 400 + refit 200 steps and the grid in {time.perf_counter() - t:.1f}s)")
    for r in t41["rows"]:
        say(f"[paper] table4_1 alpha={r['alpha']} q={r['q']}: {r['seconds']:.6f} s, ratio {r['ratio']:.3f}, "
            f"top1 {r['top1']:.4f}, top5 {r['top5']:.4f}")
    ratios = tuple(round(r["ratio"], 3) for r in t41["rows"] if r["q"] == 1)
    if ratios != TABLE_RATIOS:
        fail(f"table4_1 ratios {ratios} != the reference's {TABLE_RATIOS}")
    top1 = {r["q"]: r["top1"] for r in t41["rows"] if r["alpha"] == 0.2}
    if not top1[4] - top1[1] >= 0.05:
        fail(f"table4_1 alpha 0.2: top1 q=4 {top1[4]:.4f} - q=1 {top1[1]:.4f} < 0.05")
    if not top1[4] >= b["top1"] - 0.03:
        fail(f"table4_1 alpha 0.2: top1 q=4 {top1[4]:.4f} < baseline {b['top1']:.4f} - 0.03")
    # two compressed linears (fc0, fc1) in each of the grid's 16 forwards
    if runs["paper table4_1"]["lowrank_matmul"] < 2 * len(t41["rows"]):
        fail(f"table4_1: lowrank_matmul launched {runs['paper table4_1']['lowrank_matmul']} times on "
             f"{len(t41['rows'])} compressed forwards")
    summary["table4_1"] = {"baseline": b, "rows": t41["rows"]}

    # --- Theorem 3.2: the trained head, then one tier of llama's w_gate ------------
    params = t41["params"]
    Xte = torch.as_tensor(table4_1.datasets()[2], device="cuda")
    with torch.no_grad():
        h = table4_1.mlp_features(params, Xte)
        Wh, bias = params["fc2"]["w"].T.contiguous(), params["fc2"]["b"]  # W = 10 x 512
        p = torch.softmax(h @ Wh.T + bias, dim=-1)
        heads = {}
        strict = 0
        # rank 4 at q 1 and 4; ranks 8 and 9 at q 4 show where the bound starts to say something
        for rank, q in ((4, 1), (4, 4), (8, 4), (9, 4)):
            A, B = rsi_factors(Wh, rank, q, generator=gen(11))
            cert = certify_head(Wh, A @ B, h, gen(12), rank=rank, q=q)
            dev_max = float(torch.max(torch.abs(torch.softmax(h @ (A @ B).T + bias, dim=-1) - p)))
            # the certificate against the exact ||W - W~||_2: the power method's 32 steps are a lower
            # bound that lies within 1e-3 of s1 where (s2/s1)^64 <= 1e-4, and above s2 (1 - 1e-2)
            # elsewhere; the same R and W~ on features scaled so that the bound is 0.25
            s1, s2 = (float(v) for v in torch.linalg.svdvals(Wh - A @ B)[:2])
            converged = (s2 / s1) ** 64 <= 1e-4
            strict += converged
            lo = s1 * (1 - 1e-3) if converged else s2 * (1 - 1e-2)
            hs = h * (0.5 / (cert.spectral_error * cert.feature_radius))
            small = certify_head(Wh, A @ B, hs, gen(12), rank=rank, q=q)
            ps = torch.softmax(hs @ Wh.T + bias, dim=-1)
            dev_small = float(torch.max(torch.abs(torch.softmax(hs @ (A @ B).T + bias, dim=-1) - ps)))
            heads[f"rank {rank} q {q}"] = {"spectral_error": cert.spectral_error, "exact_s1": s1, "exact_s2": s2,
                                           "feature_radius": cert.feature_radius,
                                           "bound": cert.prob_deviation_bound, "measured_max_deviation": dev_max,
                                           "scaled_bound": small.prob_deviation_bound,
                                           "scaled_measured_max_deviation": dev_small}
            say(f"[paper] theorem 3.2 head 10x512 rank {rank} q={q}: ||W-W~||_2 {cert.spectral_error:.5f} "
                f"(exact s1 {s1:.5f}, s2 {s2:.5f}; gate [{lo:.5f}, {s1 * (1 + 1e-4):.5f}]), "
                f"R {cert.feature_radius:.3f}, bound {cert.prob_deviation_bound:.5f}, measured max deviation "
                f"{dev_max:.5f} over {h.shape[0]} test rows; features scaled to R {small.feature_radius:.5f}: "
                f"bound {small.prob_deviation_bound:.5f}, measured {dev_small:.5f}")
            if not lo <= cert.spectral_error <= s1 * (1 + 1e-4):
                fail(f"theorem 3.2 head rank {rank} q={q}: spectral error {cert.spectral_error:.6f} outside "
                     f"[{lo:.6f}, {s1 * (1 + 1e-4):.6f}] (exact s1 {s1:.6f}, s2 {s2:.6f})")
            for what, d, bound in (("", dev_max, cert.prob_deviation_bound),
                                   (" scaled", dev_small, small.prob_deviation_bound)):
                if not d <= bound + 1e-4:
                    fail(f"theorem 3.2 head rank {rank} q={q}{what}: measured {d:.6f} > bound {bound:.6f} + 1e-4")
        if not strict:
            fail("theorem 3.2 head: no rank whose residual's power method converges; the 1e-3 gate held nothing")
    del params, t41, h, Xte

    model = build_model(get_arch("llama3.2-1b"))
    t = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))
    cp, _ = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    del dense
    gate = cp["layers"]["mlp"]["w_gate"]
    a, b_ = gate["a"], gate["b"]
    tier = a.shape[-1] // 2
    cert = certify_tier(a, b_, tier, gen(13), q=4)
    col = max(float(torch.linalg.vector_norm(a[l, :, tier].float()) * torch.linalg.vector_norm(b_[l, tier, :].float()))
              for l in range(a.shape[0]))
    rel = abs(cert.spectral_error - col) / col
    summary["certify_tier"] = {"shape_a": list(a.shape), "shape_b": list(b_.shape), "tier": tier,
                               "spectral_error": cert.spectral_error, "max_column_product": col, "relative": rel}
    say(f"[paper] certify_tier llama3.2-1b w_gate a {tuple(a.shape)} b {tuple(b_.shape)} tier {tier}: "
        f"spectral error {cert.spectral_error:.6f}, max_l ||A[:, r']|| ||B[r', :]|| {col:.6f}, relative "
        f"{rel:.2e} (tolerance 2e-2; {time.perf_counter() - t:.1f}s with the compression)")
    if not rel <= 2e-2:
        fail(f"certify_tier: spectral error {cert.spectral_error:.6f} not within 2% of {col:.6f}")
    summary["theorem_3_2_head"] = heads
    del model, cp, gate, a, b_
    torch.cuda.empty_cache()

    # --- the compression CLI at full width --------------------------------------
    for rule in ("alpha", "energy"):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, rep = paper_counted(lambda: compress_cli.main(["--arch", "llama3.2-1b", "--rank-rule", rule,
                                                              "--errors"]), runs, f"paper cli {rule}")
        dt = time.perf_counter() - t
        text = buf.getvalue()
        for line in text.splitlines():
            say(f"[paper] cli {rule} | {line}")
        errs_cli = [float(line.rsplit(":", 1)[1]) for line in text.splitlines() if "spectral err" in line]
        done = [l for l in rep.layers if l.compressed]
        over = [(l.path, l.rank) for l in done if not l.rank < break_even_rank(*l.shape[-2:])]
        say(f"[paper] cli {rule}: {rep.summary()} in {dt:.1f}s; {len(errs_cli)} spectral errors")
        if not done or len(errs_cli) != len(done) or not all(e == e and abs(e) != float("inf") for e in errs_cli):
            fail(f"cli {rule}: {len(done)} compressed, errors {errs_cli}")
        if over:
            fail(f"cli {rule}: ranks at or over break-even: {over}")
        summary[f"cli_{rule}"] = {"ratio": rep.ratio, "ranks": sorted({l.rank for l in done}), "seconds": dt}
    summary["launches"] = {k: v for k, v in runs.items() if k.startswith("paper")}
    summary["paper_phase_s"] = time.perf_counter() - t_phase
    say("[paper] " + json.dumps(summary))
    return summary


# --------------------------------------------------------------------------- #
# phases 19-20: the dense archs, and engine stage 3 (prefix sharing)
# --------------------------------------------------------------------------- #
def phase_dense_main(arch: str, n_layers):
    """``arch`` at every published width (``n_layers`` None: full depth too):
    random weights (seed 0), spectralized (seed 9), QKV biases (where the
    config has them) drawn N(0, 0.02) from seed 5, RSI-compressed at alpha
    0.3 with q = 4; q = 1 factorizes layer 0's w_gate alone, for the error
    gate.  Returns (model, params, batch, summary)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.core.rsi import rsi_factors
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.models.model import analytic_param_count, build_model

    full = get_arch(arch)
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    model = build_model(cfg)
    dev = model.device
    tag = arch.split("-")[0]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))
    if cfg.qkv_bias:  # zeros at init (as in the reference), which would test nothing
        g = gen(5)
        for name in ("bq", "bk", "bv"):
            b = dense["layers"]["attn"][name]
            b.copy_(0.02 * torch.randn(b.shape, generator=g, device=dev))
    torch.cuda.synchronize()
    cut = ("no cut" if n_layers is None else
           f"n_layers {full.n_layers} -> {cfg.n_layers} (depth only: the dense {full.n_layers} layers, "
           f"{analytic_param_count(full) * 2 / 1e9:.1f} GB in bf16, do not fit one card)")
    say(f"[{tag}] {arch}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads (G = "
        f"{cfg.n_heads // cfg.n_kv_heads}), head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
        f"{cfg.vocab_padded}), untied lm_head, qkv_bias {cfg.qkv_bias}, {cfg.dtype}; {cfg.n_layers} layers, {cut}; "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params; init + spectralize {time.perf_counter() - t0:.1f}s")
    W = dense["layers"]["mlp"]["w_gate"][0].clone()
    libs = engine_libs()
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    ALIGN_COPIES.reset()
    t = time.perf_counter()
    params, rep = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t
    comp_launches = {n: lib.launches for n, lib in libs.items()}
    no_align_copies(f"{arch} compression")
    if comp_launches["sketch_matmul"] <= 0:
        fail(f"{arch}: RSI's sketch GEMMs never launched sketch_matmul during compression")
    del dense
    torch.cuda.empty_cache()
    by_path = {l.path: l.compressed for l in rep.layers}
    want = {f"layers/{g}/{n}": True for g, ns in (("attn", ("wq", "wk", "wv", "wo")),
                                                  ("mlp", ("w_gate", "w_up", "w_down"))) for n in ns}
    want.update({"lm_head": True, "embed": False})
    want.update({f"layers/attn/{b}": False for b in ("bq", "bk", "bv") if cfg.qkv_bias})
    wrong = {p: by_path.get(p) for p, c in want.items() if by_path.get(p) != c}
    if wrong:
        fail(f"{arch} compression decisions differ from the reference's: {wrong}")
    ranks = sorted({l.rank for l in rep.layers if l.compressed})
    say(f"[{tag}] compress q=4: {rep.summary()} ranks {ranks} in {comp_s:.1f}s; launches {comp_launches}")
    fallbacks = {l.path: l.qr_fallbacks for l in rep.layers if l.qr_fallbacks}
    n_qr = sum(math.prod(l.shape[:-2]) * 4 for l in rep.layers if l.compressed)  # one a power iteration
    say(f"[{tag}] sketches orthonormalized by Householder QR where CholeskyQR2's Gram was not positive definite: "
        f"{sum(fallbacks.values())} of {n_qr}, by leaf {fallbacks}")
    if cfg.qkv_bias and not float(params["layers"]["attn"]["bk"].float().abs().max()) > 0:
        fail(f"{arch}: the QKV biases are zero after compression")
    gate = params["layers"]["mlp"]["w_gate"]
    k = gate["a"].shape[-1]
    sv = torch.linalg.svdvals(W.float())
    errs = {4: float(normalized_error_factored(W, gate["a"][0], gate["b"][0], sv[k], gen(2), iters=64))}
    t = time.perf_counter()
    A1, B1 = rsi_factors(W, k, 1, generator=gen(3))
    torch.cuda.synchronize()
    q1_s = time.perf_counter() - t
    errs[1] = float(normalized_error_factored(W, A1, B1, sv[k], gen(2), iters=64))
    del A1, B1, W
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] layer 0 w_gate ({cfg.d_model}x{cfg.d_ff}, k={k}) normalized error ||W-AB||_2/s_(k+1): q=4 "
        f"{errs[4]:.4f}, q=1 {errs[1]:.4f} (that one matrix in {q1_s:.2f}s); peak device memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated, init to compressed model) on {card_line()}")
    if not errs[4] <= errs[1]:
        fail(f"{arch}: q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    toks = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    summary = {"n_layers": cfg.n_layers, "ratio": rep.ratio, "ranks": ranks, "compress_s": comp_s,
               "normalized_error": errs, "peak_gib": peak / 2**30, "compress_launches": comp_launches,
               "qr_fallbacks": fallbacks}
    return model, params, batch, summary


def share_requests(cfg, n: int = N_REQUESTS, seed: int = 0):
    """(prompts, new-token counts) of a sharing run: one SyntheticLM system
    prompt of SYS_LEN tokens (2 pages), then a SyntheticLM suffix of 16-384
    tokens, then 16-64 new tokens (numpy seed ``seed``)."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM

    rng = np.random.default_rng(seed)
    toks = SyntheticLM(cfg, batch=n + 1, seq=384, kind="serve", seed=seed + 1).at_step(0)["tokens"]
    lens = rng.integers(16, 385, size=n)
    gens = rng.integers(16, 65, size=n)
    return [np.concatenate([toks[n, :SYS_LEN], toks[i, : lens[i]]]) for i in range(n)], [int(g) for g in gens]


def share_pair(model, params, drive, label, tag, **kw):
    """The same requests through two engines that differ only in
    ``share_prefix``; ``drive(engine)`` submits and runs them and returns the
    requests.  Returns {share: (requests, engine, tok/s)}, after printing
    both runs' counters."""
    import torch

    from repro_torch.serving import Engine

    opts = dict(ENGINE, prefill_chunk=ENGINE["page_size"])  # chunk == page: every prompt through one program
    opts.update(kw)
    out = {}
    for share in (False, True):
        eng = Engine(model, params, share_prefix=share, **opts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        reqs = drive(eng)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n_tok = sum(len(r.tokens) for r in reqs)
        bad = [r.uid for r in reqs if r.status != "ok" or len(r.tokens) != r.max_new_tokens]
        if bad:
            fail(f"{tag} {label}: requests {bad} did not finish with their requested token counts")
        say(f"[{tag}] {label}, {'shared' if share else 'unshared'}: {len(reqs)} requests, {n_tok} tokens in "
            f"{dt:.3f}s = {n_tok / dt:.1f} tok/s; shared_page_hits {eng.shared_page_hits}, matched admissions "
            f"{eng.shared_admissions}, cow_forks {eng.cow_forks}, skipped_prefill_tokens "
            f"{eng.skipped_prefill_tokens}, prefix_evictions {eng.prefix_evictions}, cached pages "
            f"{eng.prefix_cached_pages}, prefill chunks {eng.prefill_chunks}, peak pages "
            f"{eng.peak_pages_in_use}/{eng.kv_pages}, graph replays {eng.graph_replays}")
        out[share] = (reqs, eng, n_tok / dt)
    return out


def share_verdict(tag, label, pair, *, bitwise: bool = True) -> dict:
    """Shared against unshared: tokens equal (a gate where ``bitwise``),
    shared_page_hits, skipped_prefill_tokens, peak pages and tok/s."""
    (u_reqs, u_eng, u_tps), (s_reqs, s_eng, s_tps) = pair[False], pair[True]
    same = [a.tokens == b.tokens for a, b in zip(u_reqs, s_reqs)]
    row = {"tokens_equal": all(same), "requests_equal": f"{sum(same)}/{len(same)}",
           "shared_page_hits": s_eng.shared_page_hits, "skipped_prefill_tokens": s_eng.skipped_prefill_tokens,
           "cow_forks": s_eng.cow_forks, "prefix_evictions": s_eng.prefix_evictions,
           "peak_pages": [u_eng.peak_pages_in_use, s_eng.peak_pages_in_use], "tok_s": [u_tps, s_tps]}
    say(f"[{tag}] {label}: shared vs unshared " + json.dumps(row))
    if bitwise and not row["tokens_equal"]:
        fail(f"{tag} {label}: shared greedy tokens differ from the unshared run's")
    if s_eng.pages_in_use != 0 or u_eng.pages_in_use != 0:
        fail(f"{tag} {label}: pages still in use after every request finished")
    return row


def phase_sharing(model, params, tag: str, runs=("a", "b", "c", "d", "a256"), report_only=()) -> dict:
    """The sharing runs: two engines that differ only in ``share_prefix``
    (page 64, 8 slots, max_len 640, 40 pages, decode block 8, greedy, the
    decode block a CUDA graph), prefill chunk 64 = the page, every prompt
    longer than one chunk, so both compute every position through the chunk
    program at one shape: shared == unshared tokens bit for bit is a gate.
    (a) 16 requests at once: one 128-token system prompt, a 16-384-token
    suffix, 16-64 new tokens.  (b) COW at the exact page boundary: three
    followers whose whole prompt is the 128 indexed tokens (gate: cow_forks
    >= 1).  (c) The session cache: turn 2 extends (turn 1's prompt + reply)
    with a new suffix and must match pages past turn 1's prompt (the
    rematerialized decode pages); then drop_session frees > 0 cached pages.
    (d) warm_cache_pages 4 in a 16-page pool (gate: prefix_evictions > 0).
    "a256": (a) at the engine's usual chunk of 256, where prompts up to 256
    tokens prefill through the flash kernel: reported, no bitwise gate.  A
    run named in ``report_only`` is printed and gates nothing (deepseek-v2's
    session run: the reference fails its own MLA session-reuse case)."""
    import numpy as np
    import torch

    from repro_torch.serving import Request

    cfg, dev = model.cfg, model.device
    prompts, gens = share_requests(cfg)
    rows = {}

    def all_at_once(eng):
        return eng.run([Request(prompt=p, max_new_tokens=g) for p, g in zip(prompts, gens)])

    if "a" in runs:
        pair = share_pair(model, params, lambda e: sorted(all_at_once(e), key=lambda r: r.uid), "(a) 16 requests",
                          tag)
        rows["a"] = share_verdict(tag, "(a) 16 requests, chunk 64", pair)
        if rows["a"]["shared_page_hits"] <= 0:
            fail(f"{tag} (a): no page was shared")
    if "b" in runs:
        def cow(eng):
            donor = eng.submit(Request(prompt=prompts[0], max_new_tokens=32))
            while not donor.tokens:  # its prompt's pages have landed and are indexed
                eng.step()
            sys = prompts[0][:SYS_LEN]
            followers = [eng.submit(Request(prompt=sys.copy(), max_new_tokens=g)) for g in (24, 40, 16)]
            while eng.has_work:
                eng.step()
            return [donor] + followers

        rows["b"] = share_verdict(tag, "(b) COW at the page boundary", share_pair(model, params, cow, "(b) COW", tag))
        if rows["b"]["cow_forks"] < 1:
            fail(f"{tag} (b): no COW fork")
    if "c" in runs:
        rng = np.random.default_rng(7)
        turn1 = [prompts[i][: SYS_LEN + int(n)] for i, n in ((1, 22), (2, 70))]
        extra = [rng.integers(0, cfg.vocab, size=(n,)) for n in (40, 9)]
        dropped = {}

        def session(eng):
            first = eng.run([Request(prompt=p.copy(), max_new_tokens=64) for p in turn1])
            first = sorted(first, key=lambda r: r.uid)
            follow = [np.concatenate([p, np.asarray(r.tokens, np.int64), x]) for p, r, x in zip(turn1, first, extra)]
            second = sorted(eng.run([Request(prompt=f, max_new_tokens=32) for f in follow]), key=lambda r: r.uid)
            past = [r.prefill_skipped - p.size for r, p in zip(second, turn1)]
            freed = sum(eng.drop_session(p) for p in turn1)
            dropped[eng.share_prefix] = (past, freed, eng.prefix_cached_pages)
            return first + second

        gated = "c" not in report_only
        pair = share_pair(model, params, session, "(c) sessions", tag)
        rows["c"] = share_verdict(tag, "(c) session cache" + ("" if gated else " (reported, no gate)"), pair,
                                  bitwise=gated)
        past, freed, left = dropped[True]
        rows["c"].update({"matched_past_turn1_prompt": past, "drop_session_freed": freed, "cached_after": left})
        if not rows["c"]["tokens_equal"]:
            i, j = next((i, next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y))
                        for i, (a, b) in enumerate(zip(pair[False][0], pair[True][0])) if a.tokens != b.tokens)
            rows["c"].update({"first_differing_request": i, "first_differing_token": j})
        say(f"[{tag}] (c) turn 2 matched {past} tokens past turn 1's prompt; drop_session freed {freed} cached "
            f"pages ({left} left)" + ("" if rows["c"]["tokens_equal"] else
                                      f"; first difference: request {rows['c']['first_differing_request']}, "
                                      f"token {rows['c']['first_differing_token']}"))
        if gated and min(past) <= 0:
            fail(f"{tag} (c): turn 2 matched no page past turn 1's prompt")
        if gated and freed <= 0:
            fail(f"{tag} (c): drop_session freed no cached page")
    if "d" in runs:
        pair = share_pair(model, params, lambda e: sorted(all_at_once(e), key=lambda r: r.uid),
                          "(d) warm cache 4, 16 pages", tag, kv_pages=16, warm_cache_pages=4)
        rows["d"] = share_verdict(tag, "(d) warm_cache_pages 4, 16-page pool", pair)
        if rows["d"]["prefix_evictions"] <= 0:
            fail(f"{tag} (d): no warm-cache eviction")
    if "a256" in runs:
        pair = share_pair(model, params, lambda e: sorted(all_at_once(e), key=lambda r: r.uid),
                          "(a) at chunk 256", tag, prefill_chunk=ENGINE["prefill_chunk"])
        row = share_verdict(tag, "(a) at chunk 256 (reported, no bitwise gate)", pair, bitwise=False)
        if not row["tokens_equal"]:
            # the first request whose tokens differ: its first-token logits, monolithic (flash; what
            # the unshared engine runs up to 256 tokens) against the system prompt's pages and the
            # tail through the chunk program (what a shared admission runs)
            i = next(j for j, (a, b) in enumerate(zip(pair[False][0], pair[True][0])) if a.tokens != b.tokens)
            p = torch.as_tensor(prompts[i][None], dtype=torch.int64, device=dev)
            L = p.shape[1]
            mono, _ = model.prefill(params, {"tokens": p}, ENGINE["max_len"])
            cache, _ = model.init_cache_paged(1, ENGINE["max_len"], ENGINE["page_size"], ENGINE["kv_pages"])
            brow = torch.arange(cache["block_table"].shape[1], dtype=torch.int32, device=dev)
            C = ENGINE["prefill_chunk"]
            for start, end in ((0, SYS_LEN), (SYS_LEN, L)):
                while start < end:
                    n = min(C, end - start)
                    chunk = torch.zeros((1, C), dtype=torch.int64, device=dev)
                    chunk[0, :n] = p[0, start:start + n]
                    shared_l, _ = model.prefill_chunk(params, cache, chunk, brow, start, n)
                    start += n
            err, scale = float((shared_l - mono).abs().max()), float(mono.abs().max())
            row.update({"first_differing_request": i, "first_token_logits_err": err,
                        "first_token_logits_tol": 5e-2 * scale})
            say(f"[{tag}] (a) at chunk 256: request {i}'s first-token logits, monolithic vs system pages + "
                f"chunked tail: max abs err {err:.4e} (5e-2 x max |logit| = {5e-2 * scale:.4e}): "
                f"{'within' if err <= 5e-2 * scale else 'OUTSIDE'}")
        rows["a256"] = row
    return rows


def phase_dense(runs: dict) -> dict:
    """Phases 19 (minitron-4b at 16 of 32 layers, sharing runs (a)-(d) and (a) at chunk 256)
    and 20 (qwen2-72b at 8 of 80 layers, run (a)): each model compressed,
    auto vs reference, the engine's gates, then its sharing runs."""
    import gc

    import torch

    out = {}
    for i, (arch, n_layers) in enumerate(DENSE_ARCHS):
        t = time.perf_counter()
        tag = arch.split("-")[0]
        model, params, batch, summary = phase_dense_main(arch, n_layers)
        # phase 5's 5% gate between two bf16 runs does not hold at 32 layers of random spectralized
        # weights (each bf16 run lies ~8% from the fp32 run): the recurrent models' three gates, the
        # bf16 runs each held against the fp32 reference run (the rule of phases 22, 24 and 25)
        summary["branch_err_ratio"] = phase_blocks_reference(model, params, batch, tag=f"{tag} reference")
        summary["reference"] = phase_deep_reference(model, params, batch, tag=f"{tag} reference",
                                                    fp32_anchored=True)
        runs[f"{arch} compression"] = summary["compress_launches"]
        # the compressed head's logits are a low-rank apply: the sketch GEMM is RSI's, above
        eng = phase_engine(model, params, tag=f"{tag} engine",
                           on_path=("lowrank_matmul", "flash_attention", "paged_decode_attention"))
        runs[f"{arch} engine"], runs[f"{arch} flat engine"] = eng["launches"], eng["launches_flat_engine"]
        summary.update(phase_chunk_profile(model, params, tag=f"{tag} chunk"))
        summary["sharing"] = phase_sharing(model, params, tag=f"{tag} sharing",
                                           runs=("a", "b", "c", "d", "a256") if i == 0 else ("a",))
        summary.update({"tok_s": eng["tok_s"], "phase_s": time.perf_counter() - t})
        say(f"[{tag}] phase {19 + i} " + json.dumps(summary))
        out[arch] = summary
        del model, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 22: h2o-danube-1.8b, the sliding-window ring
# --------------------------------------------------------------------------- #
def phase_h2o_kernels(rnd, gen, gemm_tol, attn_tol, records) -> None:
    """Phase 2 at h2o-danube-1.8b's shapes (32/8 heads, head_dim 80, window
    4096), bf16 and fp32: the flash kernel at the static (4, 256), whose
    window is out of reach, and at a (1, 16384) prompt past it (its bound
    counts the in-window pairs only; the library call is SDPA under the
    window mask, K/V repeated to 32 heads beforehand, bf16 only: fp32 SDPA
    under a 16384-square mask may take its math path's whole score matrix);
    the decode kernel over a wrapped ring (8 slots of 4096 positions, every
    slot valid); lowrank_matmul at the w_gate (2560 x 768 x 6912) at M 4
    and 8.  The bf16 records go into ``records`` under "<kernel> h2o ..."."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    from repro_torch.configs.registry import get_arch

    dev = torch.device("cuda")
    cfg = get_arch(H2O_ARCH)
    H, KV, hd, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window
    G = H // KV
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        for (B, S), key in (((BATCH, PROMPT), "flash_attention h2o hd80"),
                            ((1, H2O_LONG_PROMPT), "flash_attention h2o window 16k")):
            q, k, v = rnd((B, S, H, hd), dtype), rnd((B, S, KV, hd), dtype), rnd((B, S, KV, hd), dtype)
            got = flash_attention(q, k, v, causal=True, window=W)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            if S <= W:
                library = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)  # noqa: E731
            elif dtype == torch.bfloat16:
                mask = ref.attention_mask(S, S, causal=True, window=W, q_offset=0, device=dev)
                kr, vr = ks.repeat_interleave(G, dim=1), vs.repeat_interleave(G, dim=1)
                library = lambda: F.scaled_dot_product_attention(qs, kr, vr, attn_mask=mask)  # noqa: E731
            else:
                library = None
            check("flash_attention", [B, S, H, KV, hd, W], dtype, got,
                  ref.chunked_attention_ref(q, k, v, causal=True, window=W), rel, why,
                  kernel_fn=lambda: flash_attention(q, k, v, causal=True, window=W),
                  plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True, window=W),
                  library_fn=library, cost=kernel_cost.flash_attention(B, S, S, H, KV, hd, q.element_size(), window=W),
                  records=records, key=key)
            del q, k, v, qs, ks, vs, got, library
            torch.cuda.empty_cache()
        # the decode over a ring that has wrapped: every one of its W slots valid
        Bq = H2O_WINDOW["n_slots"]
        q, k, v = rnd((Bq, 1, H, hd), dtype), rnd((Bq, W, KV, hd), dtype), rnd((Bq, W, KV, hd), dtype)
        valid = torch.ones((Bq, W), dtype=torch.bool, device=dev)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        n_rows = Bq * W
        check("decode_attention", [Bq, W, H, KV, hd, "wrapped ring, every slot valid"], dtype,
              decode_attention(q, k, v, valid), ref.decode_attention_ref(q, k, v, valid), rel, why,
              kernel_fn=lambda: decode_attention(q, k, v, valid),
              plain_fn=lambda: ref.decode_attention_ref(q, k, v, valid),
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True),
              cost=kernel_cost.decode_attention(Bq, W, H, KV, hd, q.element_size(), n_rows=n_rows),
              records=records, key="decode_attention h2o ring")
        del q, k, v, qs, ks, vs, valid
    rel, why = gemm_tol[torch.bfloat16]
    K, r, N = H2O_W_GATE
    A, B = aligned_rows(rnd((K, r), torch.bfloat16)), aligned_rows(rnd((r, N), torch.bfloat16))
    for M in (4, 8):
        x = rnd((M, K), torch.bfloat16)
        check("lowrank_matmul", [M, K, r, N, f"{H2O_ARCH} w_gate"], torch.bfloat16, lowrank_matmul(x, A, B),
              ref.lowrank_matmul_ref(x, A, B), rel, why,
              kernel_fn=lambda: lowrank_matmul(x, A, B), plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
              cost=kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()),
              records=records, key=f"lowrank_matmul h2o M {M}")
        del x
    del A, B
    torch.cuda.empty_cache()


def window_requests(cfg):
    """The window trace: SyntheticLM prompts (seed 0) of H2O_WINDOW_PROMPTS
    tokens, H2O_WINDOW_GEN new tokens each."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serving import Request

    toks = SyntheticLM(cfg, batch=len(H2O_WINDOW_PROMPTS), seq=max(H2O_WINDOW_PROMPTS), kind="serve",
                       seed=0).at_step(0)["tokens"]
    return [Request(prompt=toks[i, :n], max_new_tokens=H2O_WINDOW_GEN) for i, n in enumerate(H2O_WINDOW_PROMPTS)]


def phase_window(model, params, runs) -> dict:
    """Phase 22 (c): the window trace, where every ring wraps (8 slots, max_len
    20480, rings of 4096): bf16 under the captured block (the main run, counts
    reset just before) and eagerly, bit for bit; fp32 with the kernels and with
    the plain versions (backend "reference", eager), the same greedy tokens
    request for request; the prefill groups (one per prompt length past the
    window, the two 6144-token prompts together); the cache's bytes at
    max_len 20480 and at 4096."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.dispatch import DispatchConfig
    from repro_torch.serving import Engine

    tag, W = "h2o window", model.cfg.sliding_window
    libs = engine_libs()
    kw = dict(libs=libs, tag=tag, base=H2O_WINDOW, requests=window_requests)
    main_tok, eng, launches, tps = serve(model, params, "bf16, CUDA graph (main run)", **kw)
    windows = sorted({k[2][3] for k in dispatch.counters() if k[0] == "flash_attention"}, key=str)
    runs[f"{H2O_ARCH} window engine"] = launches
    groups = [tuple(b[2]) for b in eng.prefill_batches]
    say(f"[{tag}] prefill micro-batches (rows, length, prompt lengths): {eng.prefill_batches}; flash_attention "
        f"windows {windows}")
    want = sorted([(n,) for n in H2O_WINDOW_PROMPTS if n != 6144] + [(6144, 6144)])
    # past the window a group is never padded; below it the pad stops at the window
    padded = [b for b in eng.prefill_batches if (b[1] != b[2][0] if b[2][0] > W else b[1] > W)]
    if sorted(groups) != want or padded:
        fail(f"{tag}: prefill groups {groups} (want {want}), padded past the window: {padded}")
    if windows != [W] or any(launches[n] <= 0 for n in ("flash_attention", "decode_attention", "lowrank_matmul")):
        fail(f"{tag}: windows {windows}, launches {launches}")
    if eng.graph_replays <= 0 or eng.peak_pages_in_use != 0:
        fail(f"{tag}: graph replays {eng.graph_replays}, pages {eng.peak_pages_in_use}")
    eager_tok, *_ = serve(model, params, "bf16, eager", cuda_graph=False, **kw)
    if eager_tok != main_tok:
        fail(f"{tag}: CUDA-graph tokens differ from the eager run's")
    say(f"[{tag}] CUDA-graph tokens == eager tokens: True")
    bytes_at = {H2O_WINDOW["max_len"]: eng.kv_bytes_capacity}
    del eng
    torch.cuda.empty_cache()
    small = Engine(model, params, **dict(H2O_WINDOW, max_len=W))
    bytes_at[W] = small.kv_bytes_capacity
    del small
    torch.cuda.empty_cache()
    say(f"[{tag}] cache bytes by max_len: {bytes_at} (rings of min(max_len, {W}) slots)")
    if len(set(bytes_at.values())) != 1:
        fail(f"{tag}: the cache takes {bytes_at} bytes: not the same at max_len {H2O_WINDOW['max_len']} as at {W}")

    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = params_fp32(params)
    tok32, *_ = serve(m32, p32, "fp32, kernels", **kw)
    ref32, *_ = serve(m32, p32, "fp32, plain versions (backend reference, eager)", cuda_graph=False,
                      dispatch=DispatchConfig(backend="reference"), **kw)
    same = [a == b for a, b in zip(tok32, ref32)]
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None) for a, b in zip(tok32, ref32)]
    say(f"[{tag}] fp32 greedy tokens, kernels == plain versions, by request: {same}; first differing index {first}")
    if not all(same):
        fail(f"{tag}: fp32 greedy tokens of the kernels differ from the plain versions' (first index {first})")
    bf_vs_32 = sum(a == b for a, b in zip(main_tok, tok32))
    say(f"[{tag}] bf16 vs fp32 (kernels) greedy streams equal: {bf_vs_32}/{len(main_tok)} (informational)")
    del m32, p32
    torch.cuda.empty_cache()
    return {"window_tok_s": tps, "window_prefill_groups": [list(g) for g in groups], "cache_bytes": bytes_at}


def phase_h2o(runs: dict) -> dict:
    """Phase 22: h2o-danube-1.8b at full width and depth, compressed (q = 4);
    (a) the static path at phase 3's shape, gated three ways as phases 19-20;
    (b) phase 7's engine gates on phase 7's trace (the ring below its
    window), and one decode block profiled; (c) the window trace."""
    import gc

    import torch

    from repro_torch.kernels import decode_attention, flash_attention, lowrank_matmul
    from repro_torch.train.serve_step import greedy_generate

    t0 = time.perf_counter()
    tag = "h2o"
    model, params, batch, summary = phase_dense_main(H2O_ARCH, None)
    libs = {"lowrank_matmul": lowrank_matmul.KERNEL, "decode_attention": decode_attention.KERNEL,
            "flash_attention": flash_attention.KERNEL}
    # (a) the static path: greedy_generate at phase 3's shape, counts reset just before
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    t = time.perf_counter()
    out = greedy_generate(model, params, batch, steps=GEN, max_len=PROMPT + GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    runs[f"{H2O_ARCH} static"] = {n: lib.launches for n, lib in libs.items()}
    if tuple(out.shape) != (BATCH, GEN) or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_padded:
        fail(f"{tag}: static tokens of shape {tuple(out.shape)} out of range")
    say(f"[{tag}] static path: generated {tuple(out.shape)} in {dt:.3f}s = {BATCH * GEN / dt:.1f} tok/s (host "
        f"clock, first call); launches {runs[f'{H2O_ARCH} static']}")
    if any(n <= 0 for n in runs[f"{H2O_ARCH} static"].values()):
        fail(f"{tag}: a kernel of the static path never launched: {runs[f'{H2O_ARCH} static']}")
    summary["branch_err_ratio"] = phase_blocks_reference(model, params, batch, tag=f"{tag} reference")
    summary["reference"] = phase_deep_reference(model, params, batch, tag=f"{tag} reference", fp32_anchored=True)
    # (b) the engine on phase 7's trace; the chunk is inert (the ring is not paged)
    eng = phase_engine(model, params, tag=f"{tag} engine",
                       on_path=("lowrank_matmul", "flash_attention", "decode_attention"))
    runs[f"{H2O_ARCH} engine"], runs[f"{H2O_ARCH} flat engine"] = eng["launches"], eng["launches_flat_engine"]
    summary.update(phase_block_profile(model, params, tag=f"{tag} block"))
    # (c) the window trace
    summary.update(phase_window(model, params, runs))
    summary.update({"tok_s": eng["tok_s"], "phase_s": time.perf_counter() - t0})
    say(f"[{tag}] phase 22 (engine tok/s on the host clock) " + json.dumps(summary))
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_h2o_only() -> int:
    """``--h2o-only``: phase 2's h2o-danube checks and phase 22 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[h2o-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    built = build_all()
    for name, so in built.items():
        log = so.with_suffix(".log")
        if log.exists():
            say(f"[ptxas {name}] {ptxas_summary(log.read_text())}")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    phase_h2o_kernels(rnd, gen, gemm_tolerances(), attention_tolerances(), records)
    say(f"[h2o-only] phase 2 checks in {time.perf_counter() - t:.1f}s")
    runs: dict = {}
    phase_h2o(runs)
    say("[h2o-only] launches " + json.dumps(runs))
    say(f"[h2o-only] in {time.perf_counter() - t:.1f}s")
    return 0


# --------------------------------------------------------------------------- #
# phase 23: deepseek-v2-236b, multi-head latent attention
# --------------------------------------------------------------------------- #
def phase_deepseek_kernels(rnd, gen, gemm_tol, attn_tol, records) -> None:
    """Phase 2 at deepseek-v2's shapes, bf16 and fp32: the flash kernel at the
    MLA prefill (128/128 heads, q/k head dim 192, v head dim 128, causal) at
    the static (4, 256), and a ragged chunk of 70 queries at q_offset 186
    over 256 keys (Skv > Sq); the batched low-rank kernel on one MoE layer's
    expert stacks (160 experts x C 128, rank 461: w_gate 5120 -> 1536,
    w_down 1536 -> 5120) with every capacity row live, then in bf16 at the
    decode occupancy (8 tokens x top-6 distinct experts, numpy seed 0), its
    bound counting the live experts' factors; lowrank_matmul at wo (16384 x
    1536 x 5120) and wq_b (1536 x 461 x 24576) at M 4 and 8; the sketch GEMM
    at one expert's w_gate (W 5120 x 1536, l 461), W @ Y and W^T @ X.  The
    flash kernel's library call is SDPA at E 192 / Ev 128 where a backend
    takes it.  The bf16 records go into ``records`` under "<kernel>
    deepseek ..."."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import aligned_rows
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul
    from repro_torch.kernels.lowrank_matmul_batched import lowrank_matmul_batched
    from repro_torch.kernels.sketch_matmul import sketch_matmul

    dev = torch.device("cuda")
    cfg = get_arch(DEEPSEEK_ARCH)
    H, hd, vd = cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        for B, Sq, Skv in ((BATCH, PROMPT, PROMPT), (2, 70, PROMPT)):
            off = Skv - Sq
            q, k, v = rnd((B, Sq, H, hd), dtype), rnd((B, Skv, H, hd), dtype), rnd((B, Skv, H, vd), dtype)
            got = flash_attention(q, k, v, causal=True, q_offset=off)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            mask = ref.attention_mask(Sq, Skv, causal=True, window=None, q_offset=off, device=dev)
            library = (lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)) if off == 0 else \
                (lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
            try:  # not every SDPA backend takes a value head dim other than the query's
                library()
                call = "SDPA, E 192 / Ev 128" + (", is_causal" if off == 0 else ", the causal mask at q_offset")
            except RuntimeError as e:
                library, call = None, f"none: SDPA at E 192 / Ev 128 raised {str(e)[:120]!r}"
            check("flash_attention", [B, Sq, Skv, H, H, hd, vd, f"q_offset {off}"], dtype, got,
                  ref.chunked_attention_ref(q, k, v, causal=True, q_offset=off), rel, why,
                  kernel_fn=lambda: flash_attention(q, k, v, causal=True, q_offset=off),
                  plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=True, q_offset=off),
                  library_fn=library,
                  cost=kernel_cost.flash_attention(B, Sq, Skv, H, H, hd, q.element_size(), q_offset=off, vd=vd),
                  records=records if off == 0 else {},
                  key="flash_attention deepseek mla" if off == 0 else None, extra={"library_call": call})
            del q, k, v, qs, ks, vs, got, mask, library
            torch.cuda.empty_cache()

    E, r = DEEPSEEK_E, DEEPSEEK_R
    cases = [(dtype, C, K, N, label, "full") for dtype in (torch.bfloat16, torch.float32)
             for C, K, N, label in DEEPSEEK_BATCHED]
    cases += [(torch.bfloat16, C, K, N, label, "decode") for C, K, N, label in DEEPSEEK_BATCHED]
    for dtype, C, K, N, label, occ in cases:
        rel, why = gemm_tol[dtype]
        x = rnd((E, C, K), dtype)
        counts = moe_decode_counts(occ, E, DEEPSEEK_TOPK)
        if counts is not None:  # rows past each count: exact zeros, as models/moe.py leaves them
            live = torch.arange(C, device=dev)[None, :] < torch.as_tensor(counts, device=dev)[:, None]
            x = torch.where(live[..., None], x, torch.zeros((), dtype=dtype, device=dev))
        n_live = E if counts is None else int((counts > 0).sum())
        rows = E * C if counts is None else int(counts.sum())
        A = aligned_rows(rnd((1, E, K, r), dtype))[0]
        B = aligned_rows(rnd((1, E, r, N), dtype))[0]
        got = lowrank_matmul_batched(x, A, B)
        want = ref.lowrank_matmul_ref(x, A, B)
        if counts is not None and not bool((got[~live] == 0).all()):
            fail(f"lowrank_matmul_batched deepseek {label} at the decode occupancy: a row past its count is not zero")
        esz = x.element_size()
        all_ms, all_by = bound(kernel_cost.lowrank_matmul_batched(E, C, K, r, N, esz), str(dtype).replace("torch.", ""))
        check("lowrank_matmul_batched", [E, C, K, r, N, f"{DEEPSEEK_ARCH} {label}", f"{occ} occupancy"], dtype, got,
              want, rel, why,
              kernel_fn=lambda: lowrank_matmul_batched(x, A, B),
              plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
              library_fn=lambda: torch.bmm(torch.bmm(x, A), B),
              cost=kernel_cost.lowrank_matmul_batched(E, C, K, r, N, esz, live_experts=n_live, live_rows=rows),
              records=records, key=f"lowrank_matmul_batched deepseek {label} {occ}",
              extra={"live_experts": n_live, "live_rows": rows, "bound_all_ms": all_ms, "bound_all_by": all_by})
        del x, A, B, got, want
        torch.cuda.empty_cache()

    for K, r, N, label in DEEPSEEK_LOWRANK:
        for dtype, Ms in ((torch.bfloat16, (4, 8)), (torch.float32, (4,))):
            rel, why = gemm_tol[dtype]
            A, B = aligned_rows(rnd((K, r), dtype)), aligned_rows(rnd((r, N), dtype))
            for M in Ms:
                x = rnd((M, K), dtype)
                check("lowrank_matmul", [M, K, r, N, f"{DEEPSEEK_ARCH} {label}"], dtype, lowrank_matmul(x, A, B),
                      ref.lowrank_matmul_ref(x, A, B), rel, why,
                      kernel_fn=lambda: lowrank_matmul(x, A, B), plain_fn=lambda: ref.lowrank_matmul_ref(x, A, B),
                      library_fn=lambda: torch.matmul(torch.matmul(x, A), B),
                      cost=kernel_cost.lowrank_matmul(M, K, r, N, x.element_size()),
                      records=records, key=f"lowrank_matmul deepseek {label} M {M}")
                del x
            del A, B

    C, D, ell = 5120, 1536, DEEPSEEK_R  # one expert's w_gate and RSI's sketch at its rank
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = gemm_tol[dtype]
        W = rnd((C, D), dtype)
        for trans, other in ((False, (D, ell)), (True, (C, ell))):
            Y = aligned_rows(rnd(other, dtype))
            M_out = D if trans else C
            check("sketch_matmul", [M_out, other[0], ell, "trans_a" if trans else "plain", f"{DEEPSEEK_ARCH} w_gate"],
                  dtype, sketch_matmul(W, Y, trans_a=trans), ref.sketch_matmul_ref(W, Y, trans_a=trans), rel, why,
                  kernel_fn=lambda: sketch_matmul(W, Y, trans_a=trans),
                  plain_fn=lambda: ref.sketch_matmul_ref(W, Y, trans_a=trans),
                  library_fn=lambda: torch.matmul(W.T if trans else W, Y),
                  cost=kernel_cost.sketch_matmul(C, D, ell, W.element_size(), trans_a=trans),
                  records=records, key="sketch_matmul deepseek" + (" trans_a" if trans else ""))
            del Y
        del W
    torch.cuda.empty_cache()


def phase_deepseek_main():
    """deepseek-v2-236b at every published width and 3 of its 60 layers (the
    dense first layer and two MoE layers): random weights (seed 0),
    spectralized (seed 9), RSI-compressed at alpha 0.3 with q = 4 (RSI's
    sketch GEMMs launched); the reference's decisions (DEEPSEEK_DECISIONS) and
    ranks; q = 1 factorizes layer 1's expert 0 w_gate alone, for the error
    gate.  Returns (model, params, batch, summary)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.core.rsi import rsi_factors
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.models.model import analytic_param_count, build_model

    full = get_arch(DEEPSEEK_ARCH)
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    model = build_model(cfg)
    dev = model.device
    tag = "deepseek"

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))  # the random init tree is freed here
    torch.cuda.synchronize()
    say(f"[{tag}] {DEEPSEEK_ARCH}: d {cfg.d_model}, {cfg.n_heads} heads, MLA q_lora {cfg.q_lora_rank}, kv_lora "
        f"{cfg.kv_lora_rank}, q/k head dim {cfg.qk_head_dim} (nope {cfg.qk_nope_dim} + rope {cfg.qk_rope_dim}), v "
        f"{cfg.v_head_dim}; {cfg.first_dense_layers} dense layer (d_ff {cfg.dense_d_ff}), {cfg.n_experts} experts "
        f"top-{cfg.top_k} + {cfg.n_shared_experts} shared (d_ff {cfg.moe_d_ff}), vocab {cfg.vocab}, untied head, "
        f"{cfg.dtype}; n_layers {full.n_layers} -> {cfg.n_layers} (depth only: the dense {full.n_layers} layers, "
        f"{analytic_param_count(full) * 2 / 1e9:.1f} GB in bf16, do not fit one card); "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params; init + spectralize {time.perf_counter() - t0:.1f}s")
    W = dense["layers"]["moe"]["experts"]["w_gate"][0, 0].clone()  # layer 1 (the first MoE layer), expert 0
    libs = engine_libs()
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    ALIGN_COPIES.reset()
    t = time.perf_counter()
    params, rep = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t
    comp_launches = {n: lib.launches for n, lib in libs.items()}
    no_align_copies(f"{DEEPSEEK_ARCH} compression")
    if comp_launches["sketch_matmul"] <= 0:
        fail(f"{DEEPSEEK_ARCH}: RSI's sketch GEMMs never launched sketch_matmul during compression")
    del dense
    torch.cuda.empty_cache()
    by_path = {l.path: l.compressed for l in rep.layers}
    wrong = {p: by_path.get(p) for p, c in DEEPSEEK_DECISIONS.items() if by_path.get(p) != c}
    if wrong:
        fail(f"{DEEPSEEK_ARCH} compression decisions differ from the reference's: {wrong}")
    ranks = sorted({l.rank for l in rep.layers if l.compressed})
    say(f"[{tag}] compress q=4: {rep.summary()} ranks {ranks} in {comp_s:.1f}s; decisions == the reference's "
        f"({len(DEEPSEEK_DECISIONS)} leaves); launches {comp_launches}")
    if ranks != DEEPSEEK_RANKS:
        fail(f"{DEEPSEEK_ARCH}: ranks {ranks}, not {DEEPSEEK_RANKS}")
    fallbacks = {l.path: l.qr_fallbacks for l in rep.layers if l.qr_fallbacks}
    say(f"[{tag}] sketches orthonormalized by Householder QR: {sum(fallbacks.values())}, by leaf {fallbacks}")
    gate = params["layers"]["moe"]["experts"]["w_gate"]
    k = gate["a"].shape[-1]
    sv = torch.linalg.svdvals(W.float())
    errs = {4: float(normalized_error_factored(W, gate["a"][0, 0], gate["b"][0, 0], sv[k], gen(2), iters=64))}
    t = time.perf_counter()
    A1, B1 = rsi_factors(W, k, 1, generator=gen(3))
    torch.cuda.synchronize()
    q1_s = time.perf_counter() - t
    errs[1] = float(normalized_error_factored(W, A1, B1, sv[k], gen(2), iters=64))
    del A1, B1, W
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] layer 1 expert 0 w_gate ({cfg.d_model}x{cfg.moe_d_ff}, k={k}) normalized error "
        f"||W-AB||_2/s_(k+1): q=4 {errs[4]:.4f}, q=1 {errs[1]:.4f} (that one matrix in {q1_s:.2f}s); peak device "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated, init to compressed model) on {card_line()}")
    if not errs[4] <= errs[1]:
        fail(f"{DEEPSEEK_ARCH}: q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    toks = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    summary = {"n_layers": cfg.n_layers, "ratio": rep.ratio, "ranks": ranks, "compress_s": comp_s,
               "normalized_error": errs, "peak_gib": peak / 2**30, "compress_launches": comp_launches,
               "qr_fallbacks": fallbacks}
    return model, params, batch, summary


def mla_absorbed_share(model, params, eng) -> dict:
    """Device time of the absorbed MLA path's products (``dispatch.MLA_OP``)
    in one eager decode step over the engine's live slots (the captured block
    runs the same kernels, but a replay has no host ranges to attribute them
    by): each product runs inside a ``record_function`` range and its
    kernels' device time is summed.  Writes one more row into each slot's
    cache, past what the engine has written: the engine is not run again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.runtime import dispatch

    tokens = torch.as_tensor(eng._tokens[:, None], dtype=torch.int64, device=model.device)
    pos = torch.as_tensor(eng._pos, dtype=torch.int64, device=model.device)
    eng.cache["block_table"].copy_(torch.as_tensor(eng._bt, device=model.device))
    originals = {n: getattr(dispatch, n) for n in ("mla_product", "mla_materialize")}

    def ranged(fn):
        def inner(*a, **kw):
            with record_function(dispatch.MLA_OP):
                return fn(*a, **kw)
        return inner

    for n, fn in originals.items():
        setattr(dispatch, n, ranged(fn))
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, eng.cache, tokens, pos)
            torch.cuda.synchronize()
    finally:
        for n, fn in originals.items():
            setattr(dispatch, n, fn)
    rows = [r for r in device_rows(prof) if r[2] != dispatch.MLA_OP]
    step_ms = sum(r[0] for r in rows) / 1e3
    mla_us = 0.0
    for e in prof.events():
        if e.name == dispatch.MLA_OP and getattr(e, "device_type", None) == DeviceType.CPU:
            mla_us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    out = {"eager_step_kernel_ms": step_ms, "mla_absorbed_ms": mla_us / 1e3,
           "mla_absorbed_share": (mla_us / 1e3) / step_ms if step_ms > 0 and mla_us > 0 else None}
    say(f"[deepseek block] one eager decode step ({eng.n_active} slots): kernels {step_ms:.3f} ms device (sum of "
        f"its kernels' times), of which the {dispatch.MLA_OP} products (materialize of wkv_b, the absorption, the "
        f"latent scores and context, the w_uv product) "
        + (f"{mla_us / 1e3:.3f} ms ({out['mla_absorbed_share']:.3f})" if mla_us > 0 else
           "not measured (the trace attributes no device time to their ranges)"))
    return out


def phase_deepseek(runs: dict) -> dict:
    """Phase 23: deepseek-v2-236b at every published width, 3 of 60 layers,
    compressed (q = 4); (a) the static path at phase 3's shape, auto against
    reference in bf16 (routing replayed, 5%) and fp32 (routing replayed,
    1e-2); (b) phase 7's engine gates, the MLA decode through no decode
    kernel and the absorbed path's products named; (c) sharing run (a) at
    chunk 64 = the page, gated bit for bit, and the session run (c),
    reported only; (d) one captured decode block profiled."""
    import dataclasses
    import gc

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import greedy_generate

    t0 = time.perf_counter()
    tag = "deepseek"
    model, params, batch, summary = phase_deepseek_main()
    runs[f"{DEEPSEEK_ARCH} compression"] = summary["compress_launches"]
    libs = {n: lib for n, lib in engine_libs().items() if n not in ("sketch_matmul", "ssd_scan")}
    on_path = ("lowrank_matmul", "lowrank_matmul_batched", "flash_attention")
    # (a) the static path: greedy_generate at phase 3's shape, counts reset just before
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    t = time.perf_counter()
    out = greedy_generate(model, params, batch, steps=GEN, max_len=PROMPT + GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    static = {n: lib.launches for n, lib in libs.items()}
    runs[f"{DEEPSEEK_ARCH} static"] = static
    if tuple(out.shape) != (BATCH, GEN) or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_padded:
        fail(f"{tag}: static tokens of shape {tuple(out.shape)} out of range")
    say(f"[{tag}] static path: generated {tuple(out.shape)} in {dt:.3f}s = {BATCH * GEN / dt:.1f} tok/s (host "
        f"clock, first call); launches {static}")
    if any(static[n] <= 0 for n in on_path) or static["decode_attention"] or static["paged_decode_attention"]:
        fail(f"{tag}: the static path's launches {static} (want {on_path} > 0, the decode kernels 0)")
    summary["static_tok_s"] = BATCH * GEN / dt
    phase_reference(model, params, batch, tag=f"{tag} reference")
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = params_fp32(params)
    phase_reference(m32, p32, batch, tag=f"{tag} reference fp32", rel=1e-2)
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the engine on phase 7's trace
    eng = phase_engine(model, params, tag=f"{tag} engine", on_path=on_path)
    runs[f"{DEEPSEEK_ARCH} engine"], runs[f"{DEEPSEEK_ARCH} flat engine"] = eng["launches"], eng["launches_flat_engine"]
    # (c) sharing at chunk 64 = the page; the session run reported only
    summary["sharing"] = phase_sharing(model, params, tag=f"{tag} sharing", runs=("a", "c"), report_only=("c",))
    # (d) one captured decode block
    summary.update(phase_block_profile(model, params, tag=f"{tag} block"))
    summary.update({"tok_s": eng["tok_s"], "phase_s": time.perf_counter() - t0})
    say(f"[{tag}] phase 23 (engine tok/s on the host clock) " + json.dumps(summary))
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_deepseek_only() -> int:
    """``--deepseek-only``: phase 2's deepseek-v2 checks and phase 23 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[deepseek-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    built = build_all()
    for name, so in built.items():
        log = so.with_suffix(".log")
        if log.exists():
            say(f"[ptxas {name}] {ptxas_summary(log.read_text())}")
            if name == "flash_attention":
                say(f"[ptxas flash_attention instances] {ptxas_flash_instances(log.read_text())}")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    phase_deepseek_kernels(rnd, gen, gemm_tolerances(), attention_tolerances(), records)
    say(f"[deepseek-only] phase 2 checks in {time.perf_counter() - t:.1f}s")
    runs: dict = {}
    phase_deepseek(runs)
    say("[deepseek-only] launches " + json.dumps(runs))
    say(f"[deepseek-only] in {time.perf_counter() - t:.1f}s")
    return 0


# --------------------------------------------------------------------------- #
# phases 24-25: llama-3.2-vision-11b and whisper-small (cross-attention,
# the encoder-decoder, per-request images and audio frames)
# --------------------------------------------------------------------------- #
def phase_noncausal_kernels(rnd, gen, attn_tol, records) -> None:
    """Phase 2 at the modality paths' non-causal shapes (NONCAUSAL_FLASH),
    bf16 and fp32: the flash kernel against its plain version (whisper's
    encoder over 1500 frames, 23.4 key tiles; cross-attention at prefill
    over 1500 frames and 1600 image tokens; at decode, Sq = 1; one key; 65
    keys, one past a tile), its library call SDPA without a mask.  At Sq = 1
    the decode kernel's time on the same keys (every position valid) is
    printed beside it, a comparison only.  Then each decode shape captured
    in a CUDA graph (q a fixed buffer, new values copied in before the
    replay): the replay equals an eager launch on the same inputs bit for
    bit.  The bf16 records go into ``records`` under "flash_attention <label>"."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    card = card_line()
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = attn_tol[dtype]
        for label, B, Sq, Skv, H, hd in NONCAUSAL_FLASH:
            q, k, v = rnd((B, Sq, H, hd), dtype), rnd((B, Skv, H, hd), dtype), rnd((B, Skv, H, hd), dtype)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            extra = {"label": label, "card": card}
            if Sq == 1 and dtype == torch.bfloat16:
                valid = torch.ones((B, Skv), dtype=torch.bool, device=q.device)
                try:  # a comparison only: the model's cross-attention runs the flash kernel
                    extra["decode_attention_ms_same_keys"] = time_ms(lambda: decode_attention(q, k, v, valid))
                except (ValueError, RuntimeError) as e:
                    extra["decode_attention_ms_same_keys"] = f"not measured: {str(e)[:120]}"
            check("flash_attention", [B, Sq, Skv, H, H, hd, "non-causal", label], dtype,
                  flash_attention(q, k, v, causal=False), ref.chunked_attention_ref(q, k, v, causal=False), rel, why,
                  kernel_fn=lambda: flash_attention(q, k, v, causal=False),
                  plain_fn=lambda: ref.chunked_attention_ref(q, k, v, causal=False),
                  library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs),
                  cost=kernel_cost.flash_attention(B, Sq, Skv, H, H, hd, q.element_size(), causal=False),
                  records=records, key=f"flash_attention {label}", extra=extra)
            del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
        for label, B, Sq, Skv, H, hd in NONCAUSAL_FLASH:
            if Sq != 1:
                continue
            q, k, v = rnd((B, 1, H, hd), dtype), rnd((B, Skv, H, hd), dtype), rnd((B, Skv, H, hd), dtype)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                flash_attention(q, k, v, causal=False)  # the first use outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = flash_attention(q, k, v, causal=False)
            same = []
            for _ in range(3):
                q.copy_(rnd((B, 1, H, hd), dtype))
                graph.replay()
                torch.cuda.synchronize()
                same.append(bool(torch.equal(out, flash_attention(q, k, v, causal=False))))
            say(f"[kernels] flash_attention {label} {str(dtype).replace('torch.', '')} captured at Sq = 1: three "
                f"replays on new queries == eager launches bit for bit: {same}")
            if not all(same):
                fail(f"flash_attention {label} {dtype}: a captured replay differs from the eager launch {same}")
            del q, k, v, out, graph


def modal_decisions(cfg) -> dict:
    """The compression decisions the reference's policy makes at full width
    (alpha 0.3, min_dim 32): every linear and the head compressed; the
    embedding and the stacked norm scales and biases dense (a 1-D leaf is
    no candidate, so the report does not list the final norm)."""
    if cfg.family == "vlm":
        lin = {**{f"layers/self/attn/{n}": True for n in ("wq", "wk", "wv", "wo")},
               **{f"layers/self/mlp/{n}": True for n in ("w_gate", "w_up", "w_down")},
               **{f"layers/cross/cross/{n}": True for n in ("wq", "wk", "wv", "wo")},
               **{f"layers/cross/mlp/{n}": True for n in ("w_gate", "w_up", "w_down")}}
        norms = {f"layers/{s}/{n}/scale": False for s in ("self", "cross") for n in ("attn_norm", "mlp_norm")}
    else:
        lin = {**{f"{s}/attn/{n}": True for s in ("enc_layers", "dec_layers") for n in ("wq", "wk", "wv", "wo")},
               **{f"dec_layers/cross/{n}": True for n in ("wq", "wk", "wv", "wo")},
               **{f"{s}/mlp/{n}": True for s in ("enc_layers", "dec_layers") for n in ("w_up", "w_down")}}
        norms = {f"{s}/{n}/{leaf}": False for s, ns in (("enc_layers", ("attn_norm", "mlp_norm")),
                                                        ("dec_layers", ("attn_norm", "cross_norm", "mlp_norm")))
                 for n in ns for leaf in ("scale", "bias")}
    return {**lin, **norms, "lm_head": True, "embed": False}


def modal_requests(cfg):
    """The modality trace: MODAL_REQUESTS SyntheticLM prompts (seed 0) of
    MODAL_PROMPTS tokens and MODAL_GEN new tokens, each request with its
    own image or frames (SyntheticLM's, the same seed)."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(MODAL_PROMPTS[0], MODAL_PROMPTS[1] + 1, size=MODAL_REQUESTS)
    lens[:2] = MODAL_PROMPTS[::-1]
    gens = rng.integers(MODAL_GEN[0], MODAL_GEN[1] + 1, size=MODAL_REQUESTS)
    data = SyntheticLM(cfg, batch=MODAL_REQUESTS, seq=MODAL_PROMPTS[1], kind="serve", seed=0).at_step(0)
    return [Request(prompt=data["tokens"][i, : lens[i]], max_new_tokens=int(gens[i]),
                    extras={k: v[i] for k, v in data.items() if k != "tokens"}) for i in range(MODAL_REQUESTS)]


def phase_modal_main(arch: str):
    """``arch`` at every published width and depth (no cut): random weights
    (seed 0), spectralized (seed 9), RSI-compressed at alpha 0.3 with q = 4;
    the reference's decisions (``modal_decisions``) and ranks (MODAL_RANKS);
    q = 1 factorizes one FFN matrix of the first block alone, for the error
    gate.  Returns (model, params, batch (phase 3's shape, with the images or
    frames), summary)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, normalized_error_factored, spectralize_params
    from repro_torch.core.rsi import rsi_factors
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.sketch_matmul import ALIGN_COPIES
    from repro_torch.models.model import analytic_param_count, build_model

    cfg = get_arch(arch)
    model = build_model(cfg)
    dev = model.device
    tag = MODAL_TAGS[arch]
    vlm = cfg.family == "vlm"

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = spectralize_params(model.init(gen(0)), gen(9))  # the random init tree is freed here
    torch.cuda.synchronize()
    shape = (f"{cfg.n_layers} layers: {cfg.n_layers // cfg.cross_attn_every} groups of "
             f"{cfg.cross_attn_every - 1} self blocks + a cross block over {cfg.n_image_tokens} image tokens"
             if vlm else f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, {cfg.n_audio_frames} "
             f"frames")
    say(f"[{tag}] {arch}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), {cfg.dtype}; {shape}; no cut; "
        f"{analytic_param_count(cfg) / 1e9:.3f}B params ({analytic_param_count(cfg) * 2 / 1e9:.1f} GB in bf16); "
        f"init + spectralize {time.perf_counter() - t0:.1f}s")
    W = (dense["layers"]["self"]["mlp"]["w_gate"][0, 0] if vlm else dense["dec_layers"]["mlp"]["w_up"][0]).clone()
    libs = engine_libs()
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    ALIGN_COPIES.reset()
    t = time.perf_counter()
    params, rep = compress_tree(dense, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t
    comp_launches = {n: lib.launches for n, lib in libs.items()}
    no_align_copies(f"{arch} compression")
    if comp_launches["sketch_matmul"] <= 0:
        fail(f"{arch}: RSI's sketch GEMMs never launched sketch_matmul during compression")
    del dense
    torch.cuda.empty_cache()
    by_path = {l.path: l.compressed for l in rep.layers}
    want = modal_decisions(cfg)
    wrong = {p: by_path.get(p) for p, c in want.items() if by_path.get(p) != c}
    if wrong:
        fail(f"{arch} compression decisions differ from the reference's: {wrong}")
    ranks = sorted({l.rank for l in rep.layers if l.compressed})
    say(f"[{tag}] compress q=4: {rep.summary()} ranks {ranks} in {comp_s:.1f}s; decisions == the reference's "
        f"({len(want)} leaves); launches {comp_launches}")
    if ranks != MODAL_RANKS[arch]:
        fail(f"{arch}: ranks {ranks}, not {MODAL_RANKS[arch]}")
    fallbacks = {l.path: l.qr_fallbacks for l in rep.layers if l.qr_fallbacks}
    say(f"[{tag}] sketches orthonormalized by Householder QR: {sum(fallbacks.values())}, by leaf {fallbacks}")
    leaf = params["layers"]["self"]["mlp"]["w_gate"] if vlm else params["dec_layers"]["mlp"]["w_up"]
    A, B = (leaf["a"][0, 0], leaf["b"][0, 0]) if vlm else (leaf["a"][0], leaf["b"][0])
    k = A.shape[-1]
    sv = torch.linalg.svdvals(W.float())
    errs = {4: float(normalized_error_factored(W, A, B, sv[k], gen(2), iters=64))}
    t = time.perf_counter()
    A1, B1 = rsi_factors(W, k, 1, generator=gen(3))
    torch.cuda.synchronize()
    q1_s = time.perf_counter() - t
    errs[1] = float(normalized_error_factored(W, A1, B1, sv[k], gen(2), iters=64))
    del A1, B1
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] {'self block 0 w_gate' if vlm else 'decoder layer 0 w_up'} ({W.shape[0]}x{W.shape[1]}, k={k}) "
        f"normalized error ||W-AB||_2/s_(k+1): q=4 {errs[4]:.4f}, q=1 {errs[1]:.4f} (that one matrix in "
        f"{q1_s:.2f}s); compression {comp_s:.1f}s, peak device memory {peak / 2**30:.2f} GiB (max_memory_allocated, "
        f"init to compressed model) on {card_line()}")
    del W
    if not errs[4] <= errs[1]:
        fail(f"{arch}: q=4 normalized error {errs[4]:.4f} > q=1's {errs[1]:.4f}")
    data = SyntheticLM(cfg, batch=BATCH, seq=PROMPT, kind="serve", seed=0).at_step(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    batch["tokens"] = batch["tokens"].long()
    summary = {"n_layers": cfg.n_layers, "ratio": rep.ratio, "ranks": ranks, "compress_s": comp_s,
               "normalized_error": errs, "peak_gib": peak / 2**30, "compress_launches": comp_launches,
               "qr_fallbacks": fallbacks}
    return model, params, batch, summary


def context_gate(model, params, batch, tag: str) -> dict:
    """Two rows with the same prompt and different images (frames): their
    prefill logits must differ, and each must equal a batch of one with its
    own image (so nothing of one row's context reaches the other)."""
    import torch

    extra, what = ("image_embed", "images") if model.cfg.family == "vlm" else ("frames", "sets of frames")
    two = {"tokens": batch["tokens"][:1].expand(2, -1).contiguous(), extra: batch[extra][:2].contiguous()}
    logits, _ = model.prefill(params, two, PROMPT + GEN)
    diff = float((logits[0] - logits[1]).abs().max())
    alone = [model.prefill(params, {"tokens": two["tokens"][i:i + 1], extra: two[extra][i:i + 1]},
                           PROMPT + GEN)[0][0] for i in range(2)]
    err = max(float((alone[i] - logits[i]).abs().max()) for i in range(2))
    tol = 5e-2 * float(logits.abs().max())  # phase 5's: another batch, another M for the low-rank kernel
    say(f"[{tag}] same prompt, two {what}: first logits differ by {diff:.4e} (max abs; gate > 0); each row "
        f"against a batch of one with its own {extra}: {err:.4e} (tol {tol:.4e}); argmax "
        f"{logits.argmax(-1).tolist()}")
    if not diff > 0 or not err <= tol:
        fail(f"{tag}: two {what} behind one prompt: logits differ by {diff:.4e}; rows vs alone {err:.4e}")
    return {"context_logit_diff": diff, "context_row_vs_alone": err}


def phase_modal(arch: str, runs: dict) -> dict:
    """Phase 24 (llama-3.2-vision-11b) or 25 (whisper-small), at every
    published width and depth, compressed (q = 4): (a) the static path at
    phase 3's shape, each row with its own image or frames (lowrank_matmul,
    flash_attention and decode_attention launched); two rows of one prompt
    and two images give other logits; auto vs reference as phase 22: fp32
    end to end within 1e-2 and bf16 against the fp32 reference run (RMS 1.2
    x, largest 1.5 x the plain versions' error); (b) phase 7's engine gates
    on the modality trace (every request finishing, graph == eager, paged
    on half the flat pool == flat, every kernel of the path launched, no
    linear outside the kernels; the prefill monolithic); (c) phase 21's
    preemption rule with the requests' own images or frames (fp32 bit for
    bit, bf16 within the spread; ``share_prefix`` is inert for the family,
    so one engine a dtype); (d) one captured decode block profiled, the
    cross-attention's flash launches at Sq = 1 in it."""
    import dataclasses
    import gc

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import greedy_generate

    t0 = time.perf_counter()
    tag = MODAL_TAGS[arch]
    model, params, batch, summary = phase_modal_main(arch)
    runs[f"{arch} compression"] = summary["compress_launches"]
    libs = {n: lib for n, lib in engine_libs().items() if n not in ("sketch_matmul", "ssd_scan")}
    on_path = ("lowrank_matmul", "flash_attention", "decode_attention")
    torch.cuda.synchronize()
    for lib in libs.values():
        lib.reset()
    t = time.perf_counter()
    out = greedy_generate(model, params, batch, steps=GEN, max_len=PROMPT + GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    static = {n: lib.launches for n, lib in libs.items()}
    runs[f"{arch} static"] = static
    if tuple(out.shape) != (BATCH, GEN) or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_padded:
        fail(f"{tag}: static tokens of shape {tuple(out.shape)} out of range")
    say(f"[{tag}] static path: generated {tuple(out.shape)} in {dt:.3f}s = {BATCH * GEN / dt:.1f} tok/s (host "
        f"clock, first call) on {card_line()}; launches {static}")
    if any(static[n] <= 0 for n in on_path) or static["paged_decode_attention"] or static["lowrank_matmul_batched"]:
        fail(f"{tag}: the static path's launches {static} (want {on_path} > 0)")
    summary["static_tok_s"] = BATCH * GEN / dt
    summary.update(context_gate(model, params, batch, tag))
    summary["reference"] = phase_deep_reference(model, params, batch, tag=f"{tag} reference", fp32_anchored=True)
    gc.collect()
    torch.cuda.empty_cache()
    eng = phase_engine(model, params, tag=f"{tag} engine",
                       on_path=("lowrank_matmul", "flash_attention", "paged_decode_attention"),
                       requests=modal_requests, base=MODAL_ENGINE)
    runs[f"{arch} engine"], runs[f"{arch} flat engine"] = eng["launches"], eng["launches_flat_engine"]
    if eng["prefill_batches"] <= 0:
        fail(f"{tag}: the engine ran no prefill micro-batch")
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = params_fp32(params)
    summary["preempt"] = phase_preempt(model, m32, params, p32, gen=MODAL_PREEMPT_GEN, shares=(False,),
                                       tag=f"{tag} preempt")
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    summary.update(phase_block_profile(model, params, tag=f"{tag} block"))
    summary.update({"tok_s": eng["tok_s"], "phase_s": time.perf_counter() - t0})
    say(f"[{tag}] phase {MODAL_PHASES[arch]} (engine tok/s on the host clock; {card_line()}) " + json.dumps(summary))
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_modal_only(arch: str) -> int:
    """``--vlm-only`` / ``--whisper-only``: phase 2's non-causal flash checks
    and phase 24 or 25 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flag = "vlm" if arch == VLM_ARCH else "whisper"
    say(f"[{flag}-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    built = build_all()
    for name, so in built.items():
        log = so.with_suffix(".log")
        if log.exists():
            say(f"[ptxas {name}] {ptxas_summary(log.read_text())}")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    records: dict = {}
    phase_noncausal_kernels(rnd, gen, attention_tolerances(), records)
    say(f"[{flag}-only] phase 2 checks in {time.perf_counter() - t:.1f}s")
    runs: dict = {}
    phase_modal(arch, runs)
    say(f"[{flag}-only] launches " + json.dumps(runs))
    say(f"[{flag}-only] in {time.perf_counter() - t:.1f}s")
    return 0


def phase_sharing_only() -> int:
    """``--sharing-only``: phases 19-20 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[sharing-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    runs: dict = {}
    phase_dense(runs)
    say(f"[sharing-only] phases 19-20 in {time.perf_counter() - t:.1f}s; launches " + json.dumps(runs))
    return 0


def stage4_model():
    """The q = 4 compressed llama3.2-1b of phase 3 (same seeds), without the
    dense and q = 1 runs around it."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, spectralize_params
    from repro_torch.models.model import build_model

    model = build_model(get_arch("llama3.2-1b"))
    gen = lambda seed: torch.Generator(device=model.device).manual_seed(seed)  # noqa: E731
    params = spectralize_params(model.init(gen(0)), gen(9))
    params, _ = compress_tree(params, CompressionPolicy(alpha=ALPHA, q=4, min_dim=32), generator=gen(1))
    return model, params


def phase_overload_only() -> int:
    """``--overload-only``: phase 21 alone, on the q = 4 llama3.2-1b."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[overload-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    model, params = stage4_model()
    phase_stage4(model, params)
    say(f"[overload-only] in {time.perf_counter() - t:.1f}s")
    return 0


def phase_cluster_only() -> int:
    """``--cluster-only``: phases 26-27 alone, on the q = 4 llama3.2-1b."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[cluster-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    model, params = stage4_model()
    say(f"[cluster-only] build and compression in {time.perf_counter() - t:.1f}s")
    cluster = phase_cluster(model, params)
    examples = phase_examples()
    say(f"[cluster-only] phase 26 in {cluster['phase_s']:.1f}s, phase 27 in {examples['phase_s']:.1f}s, together "
        f"{cluster['phase_s'] + examples['phase_s']:.1f}s: " + json.dumps({"26": cluster, "27": examples}))
    say(f"[cluster-only] in {time.perf_counter() - t:.1f}s")
    return 0


def phase_chunk_only() -> int:
    """``--chunk-only [--src DIR]``: phase 8's profiled (1, 256) prefill chunk
    on each dense model (llama3.2-1b, minitron-4b, qwen2-72b at 8 layers),
    random weights (seed 0) compressed at alpha 0.3, q = 1, on the package
    tree ``--src`` names: the chunk's device time under another tree's
    low-rank plans, in the same call."""
    import gc

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree
    from repro_torch.kernels._build import build_all
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[chunk-only] {card_line()}; package tree {SRC}")
    build_all()
    out = {}
    for arch, n_layers in (("llama3.2-1b", None), ("minitron-4b", None), ("qwen2-72b", 8)):  # minitron whole
        cfg = get_arch(arch)
        if n_layers is not None:
            import dataclasses

            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        model = build_model(cfg)
        gen = torch.Generator(device=model.device)
        params, _ = compress_tree(model.init(gen.manual_seed(0)), CompressionPolicy(alpha=ALPHA, q=1, min_dim=32),
                                  generator=gen.manual_seed(1))
        out[arch] = phase_chunk_profile(model, params, tag=f"{arch} chunk")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    say(f"[chunk-only] {SRC}: " + json.dumps(out))
    return 0


def phase_paper_only() -> int:
    """``--paper-only``: phase 18 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[paper-only] {card_line()}; package tree {SRC}")
    build_all(["sketch_matmul", "lowrank_matmul"])
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    records: dict = {}
    phase_paper({}, records)
    say("[paper-only] " + json.dumps({k: {f: v[f] for f in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                            "bound_ms", "bound_by")} for k, v in records.items()}))
    return 0



# --------------------------------------------------------------------------- #
# phase 2 (training): each autograd Function against autograd through the plain version
# --------------------------------------------------------------------------- #
def grad_tolerances() -> dict:
    """{dtype: (relative tolerance, reason)} of a Function's outputs and gradients
    against autograd through the plain version."""
    import torch

    return {torch.bfloat16: (3e-2, "bf16: the forward's roundings (the kernel's x@A, p) differ by an ulp where "
                             "fp32 sums straddle a boundary, and the twins round ds / d(xA) to bf16 where "
                             "autograd through the plain version keeps fp32"),
            torch.float32: (1e-4, "fp32: the same products summed in another order (kernel tiles, "
                            "chunked backward)")}


def grad_check(name, shape, dtype, fn, inputs, rel, why, records):
    """``fn(*inputs)`` under backend auto (the Function: the kernel forward, the
    plain backward) and under "reference" (autograd through the plain
    version), with the same inputs and cotangent: every output and every
    input's gradient within ``rel`` of its largest |value|, every gradient
    nonzero.  Times: the kernel forward alone (no grad), the Function's
    backward alone (``torch.autograd.grad`` on a kept graph) and the plain
    forward + backward.  One JSON line; the record kept under
    ``"<name> backward <shape> <dtype>"``."""
    import torch

    from repro_torch.runtime.dispatch import use_dispatch

    leaves = [t.detach().requires_grad_() for t in inputs]

    def outs(backend):
        with use_dispatch(backend=backend):
            o = fn(*leaves)
        return list(o) if isinstance(o, tuple) else [o]

    got = outs("auto")
    cot = [torch.randn(o.shape, device=o.device, dtype=torch.float32).to(o.dtype) for o in got]
    g_got = torch.autograd.grad(got, leaves, cot, retain_graph=True)
    want = outs("reference")
    g_want = torch.autograd.grad(want, leaves, cot)
    torch.cuda.synchronize()
    errs = []
    for a, b in zip(got + list(g_got), want + list(g_want)):
        scale = float(b.float().abs().max())
        errs.append((float((a.float() - b.float()).abs().max()), scale))
    ok = all(e <= rel * s and s > 0 for e, s in errs) and all(bool(torch.isfinite(g.float()).all()) for g in g_got)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: fn(*inputs), iters=10, warmup=2)
    bwd_ms = time_ms(lambda: torch.autograd.grad(got, leaves, cot, retain_graph=True), iters=5, warmup=1)

    def plain_step():
        with use_dispatch(backend="reference"):
            o = fn(*leaves)
        torch.autograd.grad(list(o) if isinstance(o, tuple) else [o], leaves, cot)

    plain_ms = time_ms(plain_step, iters=3, warmup=1)
    dname = str(dtype).replace("torch.", "")
    rec = {"name": name, "shape": shape, "dtype": dname, "ok": ok, "tol": rel, "tol_reason": why,
           "max_rel_err": [e / s for e, s in errs], "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_bwd_ms": plain_ms}
    say("[grad] " + json.dumps(rec))
    if not ok:
        fail(f"{name} {shape} {dname}: Function vs plain autograd, errors {errs} beyond {rel} of scale "
             "(or a zero / non-finite gradient)")
    records[f"{name} backward {shape} {dname}"] = rec
    del got, want, g_got, g_want
    return rec


def phase_grad_kernels(records) -> dict:
    """Phase 2's training cases: each Function at the training path's shapes,
    bf16 then fp32.  The low-rank Function at llama3.2-1b's w_gate over phase
    28's 2048 rows (2-D) and at phi3.5-moe's expert stack (batched); the flash
    Function causal at phase 28's (8, 256) with G = 4, windowed (h2o-danube's
    hd 80, window 128), non-causal (G = 1) and MLA's q/k 192 / v 128; the
    logits Function tied (llama3.2-1b's table, one 128-row sequence chunk)
    and untied (phi3.5-moe's head); the SSD Function at mamba2-130m's
    training shape (8, 64).  Then the flash kernel's lse against the plain
    forward's, and its output with and without lse, bit for bit."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.lowrank import lowrank_params
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.runtime import dispatch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(shape, dtype, scale=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x / (shape[-1] ** 0.25 if scale is None else scale)).to(dtype)

    tol = grad_tolerances()
    t = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        rel, why = tol[dtype]
        M = TRAIN["batch"] * TRAIN["seq"]
        x = rnd((M, 2048), dtype)
        f = lowrank_params(rnd((2048, 615), dtype, 2048**0.5), rnd((615, 8192), dtype, 615**0.5))
        grad_check("lowrank_matmul", [M, 2048, 615, 8192], dtype, dispatch.lowrank_apply, (x, f["a"], f["b"]),
                   rel, why, records)
        del x, f
        x = rnd((16, 128, 4096), dtype)
        f = lowrank_params(rnd((16, 4096, 1229), dtype, 4096**0.5), rnd((16, 1229, 6400), dtype, 1229**0.5))
        grad_check("lowrank_matmul_batched", [16, 128, 4096, 1229, 6400], dtype, dispatch.lowrank_apply,
                   (x, f["a"], f["b"]), rel, why, records)
        del x, f
        for label, (B, S, Skv, H, KV, hd, vd, causal, window) in (
                ("causal G 4", (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 32, 8, 64, 64, True, None)),
                ("window 128 hd 80", (4, 256, 256, 32, 8, 80, 80, True, 128)),
                ("non-causal G 1", (4, 256, 256, 12, 12, 64, 64, False, None)),
                ("mla 192/128", (2, 256, 256, 128, 128, 192, 128, True, None))):
            q, k, v = rnd((B, S, H, hd), dtype), rnd((B, Skv, KV, hd), dtype), rnd((B, Skv, KV, vd), dtype)
            fn = lambda q, k, v, c=causal, w=window: dispatch.flash_attention(q, k, v, causal=c, window=w)  # noqa: E731
            grad_check("flash_attention", [B, S, Skv, H, KV, hd, vd, label], dtype, fn, (q, k, v), rel, why, records)
            with torch.no_grad():
                out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
                _, want_lse = ref.flash_fwd_ref(q, k, v, causal=causal, window=window)
                same = torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))
            lse_err = float((lse - want_lse).abs().max()) / float(want_lse.abs().max())
            lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
            say(f"[grad] flash_attention {label} {dtype}: lse vs the plain forward's {lse_err:.3e} x max |lse| "
                f"(tol {lse_tol}); out with lse == out without, bitwise: {same}")
            if not (lse_err <= lse_tol and same):
                fail(f"flash_attention {label} {dtype}: lse error {lse_err:.3e} > {lse_tol} or out changed with lse")
            del q, k, v, out, lse, want_lse
        rows = TRAIN["batch"] * TRAIN["seq"] // 16  # one of the chunked loss's 16 sequence chunks
        for label, d, V, tied in (("tied llama3.2-1b", 2048, 128256, True), ("untied phi3.5-moe", 4096, 32064, False)):
            x, table = rnd((rows, d), dtype), rnd((V, d) if tied else (d, V), dtype)
            fn = lambda x, t, tied=tied: dispatch.logits_apply(x, t, tied=tied)  # noqa: E731
            grad_check("sketch_matmul", [rows, d, V, f"logits {label}"], dtype, fn, (x, table), rel, why, records)
            del x, table
        B, L, nh, hd, s = 8, 64, 24, 64, 128  # mamba2-130m at phase 28's (8, 64)

        def ssd(x, dtr, Bi, Ci, alog):
            return dispatch.ssd_scan(x, F.softplus(dtr.float()), Bi, Ci, -torch.exp(alog.float()), chunk=256,
                                     round_xbar=True)

        grad_check("ssd_scan", [B, L, nh, hd, s], dtype, ssd,
                   (rnd((B, L, nh, hd), dtype), rnd((B, L, nh), torch.float32, 1.0), rnd((B, L, s), dtype),
                    rnd((B, L, s), dtype), torch.log(torch.linspace(1.0, 16.0, nh, device=dev))),
                   rel, why, records)
        torch.cuda.empty_cache()
    say(f"[grad] phase 2's training cases in {time.perf_counter() - t:.1f}s")
    return records


# --------------------------------------------------------------------------- #
# phase 28: training llama3.2-1b (q = 4) and mamba2-130m on the card
# --------------------------------------------------------------------------- #
# AdamW at a constant 1e-5 on one fixed batch.  Adam's first steps move every weight by ~lr: at 1e-3
# (5% of a d**-0.5 weight at d 2048) the random spectralized model's loss went 12.1 -> 25.7 -> 34.5, at
# 1e-4 12.1 -> 16.4 before it fell; at 1e-5 it falls every step on a fixed batch (12.14 -> 11.71), while
# on fresh batches eight steps moved it by 0.04, under the batches' own spread at lr 0 (12.14 vs 12.18)
# (my chip runs, PR 26)
TRAIN = dict(batch=8, seq=256, steps=8, fail_at=5, save_every=4, lr=1e-5)
# mamba2-130m at full width through the launcher with train_lowrank_lm's --full arguments, for this many
# steps; the example's own assertion (final loss < 7.0) is run at its default (reduced) size, for
# EXAMPLE_STEPS steps: at full width the synthetic tokens are uniform over 50280 ids and each is seen
# ~once in 120 steps, so the loss stays near ln(50280) = 10.8 (11.19 after the example's 120 steps, my
# chip run, PR 26)
MAMBA_FULL_STEPS = 10
EXAMPLE_STEPS = 30


def _factor_paths(params) -> list:
    """Paths of every factor leaf (the a and b of each factored linear)."""
    from repro_torch.core.lowrank import is_lowrank

    out = []

    def walk(node, prefix):
        if is_lowrank(node):
            out.extend((f"{prefix}/a", f"{prefix}/b"))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else k)

    walk(params, "")
    return out


def grads_agree(tag, model, params, batch, *, loss_rel, norm_rel, cos_min) -> dict:
    """One step's loss and gradients with the kernels (auto) and with the plain
    versions (reference) from the same params and batch: the loss within
    ``loss_rel``, the global gradient norm within ``norm_rel``, and every
    factor leaf's gradient nonzero with cosine >= ``cos_min`` against the
    plain run's.  The auto run's dispatch paths and launches are returned."""
    import torch

    from repro_torch.kernels import flash_attention, lowrank_matmul, sketch_matmul
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.dispatch import use_dispatch
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import loss_and_grads, tree_paths

    libs = {"lowrank_matmul": lowrank_matmul.KERNEL, "flash_attention": flash_attention.KERNEL,
            "sketch_matmul": sketch_matmul.KERNEL}
    for lib in libs.values():
        lib.reset()
    dispatch.reset_counters()
    g_k, loss_k, _ = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    launches = {n: lib.launches for n, lib in libs.items()}
    paths = dispatch.counters_by_path()
    with use_dispatch(backend="reference"):
        g_r, loss_r, _ = loss_and_grads(model, params, batch)
    n_k, n_r = float(opt_mod.global_norm(g_k)), float(opt_mod.global_norm(g_r))
    flat_k, flat_r = dict(tree_paths(g_k)), dict(tree_paths(g_r))
    cos, zero = {}, []
    for path in _factor_paths(params):
        a, b = flat_k[path].float().flatten(), flat_r[path].float().flatten()
        if float(a.abs().max()) == 0.0:
            zero.append(path)
        cos[path] = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    loss_err = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
    out = {"loss_auto": float(loss_k), "loss_reference": float(loss_r), "loss_rel_err": loss_err,
           "grad_norm_auto": n_k, "grad_norm_reference": n_r, "grad_norm_rel_err": abs(n_k - n_r) / n_r,
           "factor_leaves": len(cos), "min_factor_cosine": min(cos.values()) if cos else None,
           "launches": launches, "paths": {f"{o} {p}": n for (o, p), n in sorted(paths.items())}}
    say(f"[{tag}] " + json.dumps(out))
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    say(f"[{tag}] lowest factor cosines: {worst}; tolerances: loss {loss_rel}, grad norm {norm_rel}, "
        f"cosine >= {cos_min}")
    need = [("lowrank_matmul", "fused"), ("flash_attention", "kernel"), ("logits", "kernel")]
    if any(paths.get(k, 0) <= 0 for k in need) or any(n <= 0 for n in launches.values()):
        fail(f"{tag}: the step did not run through the kernels: paths {paths}, launches {launches}")
    if zero or not cos:
        fail(f"{tag}: factor leaves with an all-zero gradient (a detach): {zero[:5]}, or none at all")
    if not (loss_err <= loss_rel and out["grad_norm_rel_err"] <= norm_rel and min(cos.values()) >= cos_min):
        fail(f"{tag}: kernels vs plain versions beyond tolerance: {json.dumps(out)}")
    del g_k, g_r
    return out


def step_profile(step_fn, state, batch) -> dict:
    """One profiled training step: device busy time (the union of the device
    events' intervals) and the device time of the forward (under
    ``train_step.forward``), the backward (autograd's engine, checkpoint
    recomputation included) and the optimizer (``train_step.optimizer``),
    each kernel charged to the range its launching CPU op sits under."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t
    parts = Counter()
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        part, p = "other", e
        while p is not None:
            if p.name.startswith("autograd::engine::evaluate_function"):
                part = "backward"
                break
            if p.name in ("train_step.forward", "train_step.optimizer"):
                part = p.name.split(".")[1]
                break
            p = p.cpu_parent
        parts[part] += sum(k.duration for k in kernels) / 1e3
    total = sum(parts.values())
    rows = device_rows(prof)
    if not rows or total <= 0:
        return {"device_ms": None, "note": "not measured: the trace holds no device time"}
    return {"wall_ms_profiler_on": wall_prof * 1e3, "device_busy_ms": device_busy_ms(prof),
            "device_ms_by_part": dict(parts),
            "shares": {k: v / total for k, v in parts.items()},
            "top_kernels": [(round(us / 1e3, 3), n, key[:70]) for us, n, key in rows[:8]]}


def phase_train(model, params, runs: dict) -> dict:
    """Phase 28: training on the card.  llama3.2-1b whole at full width,
    compressed at q = 4 (phase 3's model), batch 8 x 256 (gates 1-5), then
    mamba2-130m whole through ``experiments.train_lowrank_lm --full``."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.experiments import train_lowrank_lm
    from repro_torch.kernels import _build, flash_attention, lowrank_matmul, sketch_matmul, ssd_scan
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import build_model
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainState, make_train_step, tree_paths

    t_phase = time.perf_counter()
    tag = "train"
    cfg = model.cfg
    out = {"card": card_line()}
    data = SyntheticLM(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"], seed=0)

    def to_dev(b):
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    batch = to_dev(data.at_step(0))
    # gate 1: step 1 with the kernels and with the plain versions, bf16, all 16 layers
    t = time.perf_counter()
    out["bf16"] = grads_agree(f"{tag} bf16", model, params, batch, loss_rel=1e-2, norm_rel=5e-2, cos_min=0.99)
    # gate 2: the same at full width on 4 of the 16 layers in fp32
    n4 = min(4, cfg.n_layers)
    cfg4 = dataclasses.replace(cfg, dtype="float32", n_layers=n4)
    p4 = params_fp32({k: _slice_layers(v, n4) if k == "layers" else v for k, v in params.items()})
    out["fp32"] = grads_agree(f"{tag} fp32 4 layers", build_model(cfg4), p4, batch, loss_rel=1e-4, norm_rel=1e-3,
                              cos_min=0.9999)
    del p4
    torch.cuda.empty_cache()
    out["gates_1_2_s"] = time.perf_counter() - t

    # gates 3 and 5: eight steps lower the loss, with no aligned-row copy; the launches of the run
    opt = opt_mod.adamw(opt_mod.constant_schedule(TRAIN["lr"]), weight_decay=0.01)
    step_fn = make_train_step(model, opt)

    def fresh():
        return TrainState(params=params, opt_state=opt.init(params), step=torch.zeros((), dtype=torch.int32))

    libs = {"lowrank_matmul": lowrank_matmul.KERNEL, "flash_attention": flash_attention.KERNEL,
            "sketch_matmul": sketch_matmul.KERNEL}
    for lib in libs.values():
        lib.reset()
    _build.ALIGN_COPIES.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []

    def at_step(step):  # one batch for every step: see TRAIN
        return data.at_step(0)

    runner = TrainLoopRunner(step_fn, at_step, None, save_every=10**9)
    t = time.perf_counter()
    state_a, _ = runner.run(fresh(), TRAIN["steps"], shard_fn=to_dev,
                            on_metrics=lambda s, m: losses.append(float(m["loss"])))
    torch.cuda.synchronize()
    out["steps_s"] = time.perf_counter() - t
    runs["llama3.2-1b train"] = {n: lib.launches for n, lib in libs.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    host = sorted(runner.watchdog.durations[1:])  # the first step pays the allocator's warm-up
    out.update(losses=losses, step_host_ms_median=host[len(host) // 2] * 1e3, align_copies=_build.ALIGN_COPIES.count,
               launches=runs["llama3.2-1b train"])
    say(f"[{tag}] 8 steps, AdamW at {TRAIN['lr']}, one batch: losses {[round(x, 4) for x in losses]}; host step median {out['step_host_ms_median']:.1f} "
        f"ms; peak {out['peak_gib']:.2f} GiB; ALIGN_COPIES {out['align_copies']}; launches {out['launches']}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: eight steps did not lower the loss: {losses}")
    if out["align_copies"]:
        fail(f"{tag}: the training steps copied {out['align_copies']} operands into aligned rows")
    if any(n <= 0 for n in out["launches"].values()):
        fail(f"{tag}: a kernel of the training path never launched: {out['launches']}")
    prof = step_profile(step_fn, state_a, batch)
    if prof.get("device_busy_ms"):
        prof["host_ms"] = out["step_host_ms_median"]
        prof["idle_share"] = max(0.0, 1 - prof["device_busy_ms"] / out["step_host_ms_median"])
    out["profile"] = prof
    say(f"[{tag}] one step profiled (batch {TRAIN['batch']} x {TRAIN['seq']}; {out['card']}): " + json.dumps(prof))
    want = dict(tree_paths(state_a.params))
    del state_a
    gc.collect()
    torch.cuda.empty_cache()

    # gate 4: fail at step 5, restore the step-4 checkpoint, resume to step 8: the same bits
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        c = ckpt.Checkpointer(d, keep=1, codec="raw")
        t = time.perf_counter()
        try:
            TrainLoopRunner(step_fn, at_step, c, save_every=TRAIN["save_every"]).run(
                fresh(), TRAIN["steps"], shard_fn=to_dev, fail_at=lambda s: s == TRAIN["fail_at"])
            fail(f"{tag}: the injected failure at step {TRAIN['fail_at']} did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        c.wait()
        out["interrupted_s"] = time.perf_counter() - t
        if ckpt.latest_step(d) != TRAIN["save_every"]:
            fail(f"{tag}: latest checkpoint {ckpt.latest_step(d)}, expected step {TRAIN['save_every']}")
        t = time.perf_counter()
        restored, manifest = ckpt.restore(fresh(), d)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t
        out["checkpoint_gib"] = sum(os.path.getsize(os.path.join(d, f"step_{TRAIN['save_every']}", m["file"]))
                                    for m in manifest["leaves"]) / 2**30
        t = time.perf_counter()
        state_b, _ = TrainLoopRunner(step_fn, at_step, None).run(restored, TRAIN["steps"], shard_fn=to_dev,
                                                                 start_step=int(restored.step))
        torch.cuda.synchronize()
        out["resumed_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    differ = [p for p, t in tree_paths(state_b.params)
              if not torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                                 want[p].view(torch.int16) if t.dtype == torch.bfloat16 else want[p])]
    say(f"[{tag}] restart: failed at step {TRAIN['fail_at']} ({out['interrupted_s']:.1f}s with the step-4 save), "
        f"restored step {TRAIN['save_every']} ({out['checkpoint_gib']:.2f} GiB, codec raw) in {out['restore_s']:.1f}s, "
        f"resumed to {TRAIN['steps']} in {out['resumed_s']:.1f}s: {len(want) - len(differ)}/{len(want)} param leaves "
        f"bit-identical to the uninterrupted run; gates 1-2 took {out['gates_1_2_s']:.1f}s, the 8 steps "
        f"{out['steps_s']:.1f}s")
    if differ:
        fail(f"{tag}: the resumed run's params differ from the uninterrupted run's: {differ[:5]}")
    del state_b, restored, want
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-130m whole, through the launcher with the example's --full arguments: ssd_scan on its forward
    mamba_libs = {"ssd_scan": ssd_scan.KERNEL, "lowrank_matmul": lowrank_matmul.KERNEL,
                  "sketch_matmul": sketch_matmul.KERNEL}
    for lib in mamba_libs.values():
        lib.reset()
    dispatch.reset_counters()
    t = time.perf_counter()
    _, metrics = train_cli.main(["--arch", "mamba2-130m", "--steps", str(MAMBA_FULL_STEPS), "--batch", "8", "--seq",
                                 "64", "--compress-alpha", "0.5", "--compress-q", "4"])
    paths = dispatch.counters_by_path()
    out["mamba2"] = {"steps": MAMBA_FULL_STEPS, "final_loss": float(metrics["loss"]), "seconds": time.perf_counter() - t,
                     "launches": {n: lib.launches for n, lib in mamba_libs.items()},
                     "ssd_scan_kernel_calls": paths.get(("ssd_scan", "kernel"), 0)}
    runs["mamba2-130m train"] = out["mamba2"]["launches"]
    say(f"[{tag}] mamba2-130m full width, {MAMBA_FULL_STEPS} steps: " + json.dumps(out["mamba2"]))
    if (out["mamba2"]["launches"]["ssd_scan"] <= 0 or out["mamba2"]["ssd_scan_kernel_calls"] <= 0
            or not math.isfinite(out["mamba2"]["final_loss"])):
        fail(f"{tag} mamba2-130m: ssd_scan was not on the training forward, or the loss is not finite: "
             f"{out['mamba2']}")
    # the example itself at its default size, its own assertion (final loss < 7.0) gating
    t = time.perf_counter()
    try:
        _, metrics = train_lowrank_lm.main(["--steps", str(EXAMPLE_STEPS)])
    except AssertionError as e:
        fail(f"{tag} train_lowrank_lm: {e}")
    out["example"] = {"final_loss": float(metrics["loss"]), "seconds": time.perf_counter() - t}
    say(f"[{tag}] experiments.train_lowrank_lm (reduced mamba2-130m, {EXAMPLE_STEPS} steps): "
        + json.dumps(out["example"]))
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{tag}] phase 28 in {out['phase_s']:.1f}s")
    return out


def _slice_layers(tree, n: int):
    """The first ``n`` layers of a stacked (L, ...) subtree (views)."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_train_only() -> int:
    """``--train-only``: phase 2's training cases and phase 28 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[train-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    phase_grad_kernels({})
    model, params = stage4_model()
    say(f"[train-only] build, phase 2's training cases and compression in {time.perf_counter() - t:.1f}s")
    phase_train(model, params, {})
    say(f"[train-only] in {time.perf_counter() - t:.1f}s")
    return 0


# --------------------------------------------------------------------------- #
# phase 29: the multi-device layer on ranks that share the card
# --------------------------------------------------------------------------- #
MULTI_WORLD, MULTI_MESH = 8, (2, 4)  # ("data", "model"): qwen2's w_gate in 4096 x 7392 blocks
MULTI_RSI_K, MULTI_RSI_Q = 2458, 4  # alpha 0.3 of 8192
MULTI_MOE_CF = 8.0  # capacity factor: every expert takes every assignment, so nothing drops
MULTI_MOE_TOKENS = (8, 256)
MULTI_PIPE_STAGES, MULTI_PIPE_MICROBATCHES, MULTI_PIPE_BATCH = 4, 4, (8, 256)
MULTI_PSGD_RANK, MULTI_PSGD_NOISE = 8, 0.05
MULTI_LAYER_MATRICES = {  # one llama3.2-1b layer's matrices (C, D) at full width
    "wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512), "wo": (2048, 2048),
    "w_gate": (2048, 8192), "w_up": (2048, 8192), "w_down": (8192, 2048)}
MULTI_KERNELS = ("sketch_matmul", "lowrank_matmul_batched", "flash_attention", "lowrank_matmul")
# (f): the tensor-parallel program on the q = 4 llama3.2-1b at full width, 2 of its 16 layers (the
# collectives go through the host under gloo: the tied table's 65 MB blocks are the largest), one AdamW
# step at batch 8 x 256, then a prefill of those prompts and 8 greedy decode steps over a 264-slot cache
# (66 a rank of "model")
MULTI_TP_LAYERS, MULTI_TP_BATCH, MULTI_TP_DECODE, MULTI_TP_LR = 2, (8, 256), 8, 1e-3
MULTI_TP_KERNELS = ("lowrank_matmul", "flash_attention", "sketch_matmul", "decode_attention")
MULTI_TP_ARG_SLACK = 2**20  # the allocator's requested bytes of a rank's arguments against its dry count
MULTI_TP_ALLOC_REL = 0.01  # the train step's allocated bytes (rounded blocks) against it (phase 30's rule)


def _multi_kernels() -> dict:
    from repro_torch.kernels import (decode_attention, flash_attention, lowrank_matmul, lowrank_matmul_batched,
                                     sketch_matmul)

    return {"sketch_matmul": sketch_matmul.KERNEL, "lowrank_matmul_batched": lowrank_matmul_batched.KERNEL,
            "flash_attention": flash_attention.KERNEL, "lowrank_matmul": lowrank_matmul.KERNEL,
            "decode_attention": decode_attention.KERNEL}


def _tree_bytes(*trees) -> int:
    """The bytes of the distinct storages under ``trees`` (a TrainState's
    fields included), as the dry-run's op counter counts its arguments."""
    from repro_torch.roofline.op_stats import _tensors

    seen = {}
    for t in _tensors(list(trees)):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _alloc_bytes(dev) -> tuple:
    """(requested, allocated) bytes of the caching allocator now, after
    what is unreferenced is collected and cuBLAS's workspaces released."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    st = torch.cuda.memory_stats(dev)
    if "requested_bytes.all.current" not in st:
        raise RuntimeError("the caching allocator keeps no requested_bytes statistic")
    return st["requested_bytes.all.current"], st["allocated_bytes.all.current"]


def multi_tp(mesh, inp: dict, part) -> dict:
    """(f) on this rank: its blocks of the q = 4 llama3.2-1b (2 layers) under
    the production rules, one AdamW step, a prefill and
    ``MULTI_TP_DECODE`` greedy decode steps over the cache split over
    "model"; each step's argument bytes as the caching allocator counts
    them (the bytes requested for the blocks, the optimizer state, the
    batch rows and the prefill's cache, and those allocated for the train
    step's), its tensors' storages beside them, and its collectives
    (``distributed.collective_counts``)."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models.model import build_model
    from repro_torch.runtime import distributed
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.sharding.rules import layout_specs, shard_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.tree import tree_paths

    dev = mesh.device
    cfg = inp["tp_cfg"]
    model = build_model(cfg, device=dev)
    rules = make_rules(mesh, sequence_parallel=True)
    specs = layout_specs(inp["tp_params"], rules)
    opt = opt_mod.adamw(opt_mod.constant_schedule(MULTI_TP_LR))
    r0, a0 = _alloc_bytes(dev)
    blocks = shard_params(inp["tp_params"], rules, specs=specs)
    r1, _ = _alloc_bytes(dev)
    state = TrainState(params=blocks, opt_state=opt.init(blocks), step=torch.zeros((), dtype=torch.int32))
    batch = shard_batch({"tokens": inp["tp_tokens"], "targets": inp["tp_targets"]}, rules)
    r2, a2 = _alloc_bytes(dev)
    # the allocator's requested bytes are gated; its allocated bytes round each block up (a block of over
    # 1 MB keeps a remainder of its segment under 1 MB unsplit in its own count) and are gated at 1 %
    args = {"train": _tree_bytes(state, batch)}
    alloc = {"train": r2 - r0, "train_allocated": a2 - a0, "blocks": r1 - r0}
    colls = {}
    fn = make_train_step(model, opt, rules=rules, specs=specs)

    def train():
        distributed.reset_collective_counts()
        with use_dispatch(DispatchConfig.from_arch(cfg)):
            r = fn(state, batch)
        torch.cuda.synchronize(dev)
        colls["train"] = distributed.collective_counts()
        return r

    new, metrics = part("f_train", train)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {k: v.detach().cpu() for k, v in tree_paths(new.params)}}
    del new, state

    rows = batch["tokens"]
    S, ML = rows.shape[1], rows.shape[1] + MULTI_TP_DECODE
    prefill = make_prefill_step(model, rules=rules, max_len=ML)
    decode = make_decode_step(model, rules=make_rules(mesh, sequence_parallel=False))
    keep = mesh.coords["model"] == 0

    def generate():
        toks, logits_out = [], []
        with torch.no_grad(), use_dispatch(DispatchConfig.from_arch(cfg)):
            r_pre, _ = _alloc_bytes(dev)
            distributed.reset_collective_counts()
            logits, cache = prefill(blocks, {"tokens": rows})
            torch.cuda.synchronize(dev)
            colls["prefill"] = distributed.collective_counts()
            # what the prefill left allocated is its logits and the cache
            cache_alloc = _alloc_bytes(dev)[0] - r_pre - logits.untyped_storage().nbytes()
            args["prefill"] = _tree_bytes(blocks, {"tokens": rows})
            alloc["prefill"] = alloc["blocks"] + _tree_bytes(rows)
            for i in range(MULTI_TP_DECODE + 1):
                full = distributed.all_gather(logits, "model", mesh, dim=-1)  # this rank's rows, every id
                tok = torch.argmax(full, dim=-1)
                toks.append(tok.cpu())
                if keep:
                    logits_out.append(full.float().cpu())
                if i == MULTI_TP_DECODE:
                    break
                if i == 0:
                    tok_bytes = tok[:, None].numel() * tok.element_size()
                    args["decode"] = _tree_bytes(blocks, cache) + tok_bytes
                    alloc["decode"] = alloc["blocks"] + cache_alloc + tok_bytes
                    distributed.reset_collective_counts()
                logits, cache = decode(blocks, cache, tok[:, None], S + i)
                if i == 0:
                    torch.cuda.synchronize(dev)
                    colls["decode"] = distributed.collective_counts()
        return torch.stack(toks, 1), logits_out, {k: tuple(v.shape) for k, v in tree_paths(cache)}

    toks, logits_out, cache_shapes = part("f_generate", generate)
    out.update(tokens=toks, logits=logits_out if keep else None, cache_shapes=cache_shapes, args=args,
               alloc=alloc, colls=colls)
    return out


def tp_dry_counts(cfg, params, rank: int) -> dict:
    """(f)'s three steps on rank ``rank`` of the dry (2, 4) mesh, on fakes of
    ``params``' shapes: each step's argument bytes and collectives by axis,
    as the dry-run counts them."""
    import torch

    from repro_torch.launch.mesh import make_rules
    from repro_torch.models.model import build_model
    from repro_torch.roofline import dry, op_stats
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.runtime.distributed import MeshSpec, dry_mesh
    from repro_torch.sharding.rules import layout_specs, shard_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.tree import tree_map

    out = {}
    B, S = MULTI_TP_BATCH
    rows = B // MULTI_MESH[0]
    with dry.dry_world():
        fake = tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype), params)
        mesh = dry_mesh(MeshSpec(MULTI_MESH, ("data", "model")), rank)
        rules = make_rules(mesh, sequence_parallel=True)
        specs = layout_specs(fake, rules)
        blocks = shard_params(fake, rules, specs=specs)
        model = build_model(cfg)
        opt = opt_mod.adamw(opt_mod.constant_schedule(MULTI_TP_LR))
        state = TrainState(params=blocks, opt_state=opt.init(blocks), step=torch.zeros((), dtype=torch.int32))
        batch = {"tokens": torch.zeros((rows, S), dtype=torch.int64),
                 "targets": torch.zeros((rows, S), dtype=torch.int64)}
        fn = make_train_step(model, opt, rules=rules, specs=specs)
        policy = DispatchConfig.from_arch(cfg)

        def count(name, step, arguments):
            r, st = op_stats.measure(step, arguments=arguments)
            out[name] = {"argument_bytes": st.argument_bytes, "by_axis": dict(st.coll_by_axis), "ops": st.coll_ops}
            return r

        def train():
            with use_dispatch(policy):
                return fn(state, batch)

        count("train", train, (state, batch))
        prefill = make_prefill_step(model, rules=rules, max_len=S + MULTI_TP_DECODE)
        decode = make_decode_step(model, rules=make_rules(mesh, sequence_parallel=False))
        toks = {"tokens": batch["tokens"]}

        def pf():
            with use_dispatch(policy), torch.no_grad():
                return prefill(blocks, toks)

        _, cache = count("prefill", pf, (blocks, toks))
        tok = torch.zeros((rows, 1), dtype=torch.int64)

        def dc():
            with use_dispatch(policy), torch.no_grad():
                return decode(blocks, cache, tok, S)

        count("decode", dc, (blocks, cache, tok))
    return out


def _sha(t) -> str:
    import hashlib

    import torch

    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"").hexdigest()[:16]


def pipe_block(lp, h, cfg):
    """One llama block over a whole (b, S, d) sequence (the trunk's own)."""
    import torch

    from repro_torch.models import lm

    positions = torch.arange(h.shape[1], device=h.device).expand(h.shape[0], h.shape[1])
    return lm._self_block(lp, h, cfg, positions)[0]


def _rsi_errors(blk, res, mesh):
    """(||W - U S Vt||_F / ||W||_F over the whole matrix, from this rank's blocks)."""
    import torch

    from repro_torch.runtime.distributed import psum

    w = blk.float()
    d2 = torch.sum(torch.square(w - (res.U.float() * res.S.float()[None]) @ res.Vt.float()))
    n2 = torch.sum(torch.square(w))
    both = psum(psum(torch.stack([d2, n2]).double(), "data", mesh), "model", mesh)
    return float(torch.sqrt(both[0] / both[1]))


def multi_ranks(mesh, inp: dict, ckpt_dir: str) -> dict:
    """Phase 29's rank program: (a)-(e) on this rank, each sub-phase between
    barriers, its seconds on rank 0's clock; launches per kernel per part."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core import gradient_compression as gc
    from repro_torch.core.distributed_rsi import distributed_rsi
    from repro_torch.core.rsi import QR_FALLBACKS
    from repro_torch.models import moe
    from repro_torch.runtime import distributed
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.runtime.distributed import MeshSpec, NamedSharding, local_block, psum
    from repro_torch.sharding.rules import MeshRules, use_rules
    from repro_torch.train.pipeline_parallel import gpipe_apply
    from repro_torch.tree import tree_map, tree_paths

    rank, dev = mesh.rank, mesh.device
    kernels = _multi_kernels()
    out = {"rank": rank, "launches": {}, "seconds": {}}

    def fence():
        torch.cuda.synchronize(dev)
        dist.barrier()

    def part(name, fn):
        for k in kernels.values():
            k.reset()
        fence()
        t = time.perf_counter()
        r = fn()
        fence()
        out["seconds"][name] = time.perf_counter() - t
        out["launches"][name] = {n: k.launches for n, k in kernels.items()}
        return r

    # (a) distributed RSI on qwen2-72b's w_gate and on a decaying spectrum of its width
    factors = {}
    for key in ("qwen", "spectral"):
        blk = local_block(inp[f"W_{key}"], ("data", "model"), mesh, rank)
        QR_FALLBACKS.reset()
        res = part(f"a_{key}", lambda: distributed_rsi(blk, MULTI_RSI_K, MULTI_RSI_Q, omega=inp["omega"]))
        rec = {"err": _rsi_errors(blk, res, mesh), "fallbacks": QR_FALLBACKS.count,
               "U_shape": tuple(res.U.shape), "Vt_shape": tuple(res.Vt.shape),
               "U_sha": _sha(res.U), "Vt_sha": _sha(res.Vt), "S_sha": _sha(res.S)}
        if key == "spectral":  # each rank's share of ||A_dist - A_single||_F against ||A_single||_F
            U1, S1, Vt1 = inp["single_U"], inp["single_S"], inp["single_Vt"]
            a1 = (local_block(U1, ("data", None), mesh, rank) * S1[None]) @ local_block(Vt1, (None, "model"), mesh,
                                                                                    rank)
            ad = (res.U.float() * res.S.float()[None]) @ res.Vt.float()
            both = torch.stack([torch.sum(torch.square(ad - a1)), torch.sum(torch.square(a1))]).double()
            both = psum(psum(both, "data", mesh), "model", mesh)
            rec["recon_rel"] = float(torch.sqrt(both[0] / both[1]))
            del a1, ad
        else:
            factors = {"U": res.U, "S": res.S, "Vt": res.Vt}
        out[f"a_{key}"] = rec
    # gloo's all-reduce of a CUDA tensor (through the host) at RSI's sizes: X over "model", Y over "data"
    ar = {}
    for name, shape, axis in (("X", (4096, MULTI_RSI_K), "model"), ("Y", (7392, MULTI_RSI_K), "data")):
        t = torch.randn(shape, device=dev)
        times = []
        for _ in range(3):
            fence()
            t0 = time.perf_counter()
            psum(t, axis, mesh)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        ar[name] = {"shape": list(shape), "axis": axis, "ranks": mesh.shape[axis], "MB": t.numel() * 4 / 1e6,
                    "ms": sorted(times)[1] * 1e3}
        del t
    out["allreduce"] = ar

    # (b) expert-parallel MoE: one phi3.5-moe layer, compressed, 4 experts a rank, tokens over "data"
    cfg = inp["moe_cfg"]
    rules = MeshRules(mesh)
    x = inp["moe_x"]
    x_loc = local_block(x, rules.spec(("batch", None, None), tuple(x.shape)), mesh, rank)
    for tag, p, xx in (("fp32", inp["moe_p32"], x_loc.float()), ("bf16", inp["moe_p"], x_loc)):
        with use_rules(rules):
            y, aux = part(f"b_{tag}", lambda: moe.moe_forward(p, xx, cfg))
        ids = moe._route(xx.reshape(-1, xx.shape[-1]), p["router"]["gate_w"], cfg)[0]
        out[f"b_{tag}"] = {"aux": float(aux), "y_sha": _sha(y), "ids": ids.cpu(),
                           "y": y.cpu() if mesh.coords["model"] == 0 else None}

    # (c) GPipe: llama3.2-1b's 16 layers in 4 stages over "pod"; the two "data" rows run the same pipeline
    pipe = distributed.make_mesh((2, MULTI_PIPE_STAGES), ("data", "pod"))
    lcfg = inp["llama_cfg"]
    stage = _tree_blocks(inp["llama_layers"], pipe, rank)
    with distributed.use_mesh(pipe), use_dispatch(DispatchConfig.from_arch(lcfg)), torch.no_grad():
        fn = gpipe_apply(lambda lp, h: pipe_block(lp, h, lcfg), n_microbatches=MULTI_PIPE_MICROBATCHES)
        y = part("c", lambda: fn(stage, inp["llama_x0"]))
    out["c"] = {"y_sha": _sha(y), "y": y.cpu() if rank == 0 else None}
    # (c)'s backward: every stage's loss <y, wo>; the psum over the 4 stages makes a slice's
    # gradient 4 x dL/dslice, held here to this stage's slice of the single rank's gradient
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), stage)

    def backward():
        with distributed.use_mesh(pipe), use_dispatch(DispatchConfig.from_arch(lcfg)):
            yg = fn(live, inp["llama_x0"])
            torch.sum(yg.float() * inp["pipe_wo"]).backward()

    part("c_backward", backward)
    ref_g = _tree_blocks(inp["pipe_grads"], pipe, rank)
    errs = {}
    for (path, g), (_, r) in zip(tree_paths(live), tree_paths(ref_g)):
        g = g.grad if g.grad is not None else torch.zeros_like(g)
        errs[path] = (float((g.float() / MULTI_PIPE_STAGES - r.float()).abs().max()), float(r.float().abs().max()))
    out["c_backward"] = {"worst": max(errs.items(), key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30)),
                         "leaves": len(errs)}
    del live, ref_g

    # (d) PowerSGD over 8 data ranks: a shared rank-8 signal plus this rank's noise
    dp = distributed.make_mesh((MULTI_WORLD,), ("data",))
    shared, own = torch.Generator(device=dev).manual_seed(11), torch.Generator(device=dev).manual_seed(100 + rank)
    grads = {}
    for name, (c, d) in MULTI_LAYER_MATRICES.items():
        u = torch.randn((c, MULTI_PSGD_RANK), generator=shared, device=dev)
        v = torch.randn((MULTI_PSGD_RANK, d), generator=shared, device=dev)
        grads[name] = u @ v + MULTI_PSGD_NOISE * torch.randn((c, d), generator=own, device=dev)
    pcfg = gc.PowerSGDConfig(rank=MULTI_PSGD_RANK, min_size=1024)
    state = gc.init_powersgd(grads, pcfg, generator=torch.Generator(device=dev).manual_seed(1))
    with distributed.use_mesh(dp):
        mean, _ = part("d_compressed", lambda: gc.compress_allreduce(grads, state, "data", pcfg))
        dense = part("d_dense", lambda: {k: distributed.pmean(g, "data") for k, g in grads.items()})
    corr = {k: float(torch.sum(mean[k] * dense[k]) / (torch.linalg.norm(mean[k]) * torch.linalg.norm(dense[k])))
            for k in grads}
    out["d"] = {"corr": corr, "bytes": gc.comm_bytes(grads, pcfg)}
    del grads, dense, mean

    # (e) the elastic reshard: (a)'s factors saved from (2, 4), restored onto (8, 1)
    specs = {"U": ("data", None), "S": (), "Vt": (None, "model")}
    live = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    target = MeshSpec((MULTI_WORLD, 1), ("data", "model"))
    t8 = {k: NamedSharding(target, s) for k, s in specs.items()}

    def reshard():
        ckpt.save(factors, ckpt_dir, 1, codec="raw", shardings=live)
        return ckpt.restore(factors, ckpt_dir, shardings=t8)[0]

    restored = part("e", reshard)
    i = mesh.coords["model"]
    rows, cols = restored["U"].shape[0], factors["Vt"].shape[1]
    out["e"] = {"U": torch.equal(restored["U"], factors["U"][i * rows:(i + 1) * rows]),
                "S": torch.equal(restored["S"], factors["S"]),
                "Vt": torch.equal(restored["Vt"][:, i * cols:(i + 1) * cols], factors["Vt"]),
                "U_shape": tuple(restored["U"].shape), "Vt_shape": tuple(restored["Vt"].shape)}
    del factors, restored

    # (f) the tensor-parallel program
    out["f"] = multi_tp(mesh, inp, part)
    return out


def tp_references(model, params) -> dict:
    """(f)'s single-card references: the model cut to MULTI_TP_LAYERS, its
    batch, one AdamW step in bf16 and in fp32 (the anchor of (i)'s
    tolerance), ``greedy_generate`` of the prompts and each step's logits
    (the prefill, then the decode steps fed its greedy tokens)."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.serve_step import greedy_generate
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(model.cfg, n_layers=MULTI_TP_LAYERS)
    fmodel = build_model(cfg)
    fparams = {**params, "layers": tree_map(lambda t: t[:MULTI_TP_LAYERS], params["layers"])}
    gen = torch.Generator().manual_seed(29)
    B, S = MULTI_TP_BATCH
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    targets = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    batch = {"tokens": tokens.cuda(), "targets": targets.cuda()}
    opt = opt_mod.adamw(opt_mod.constant_schedule(MULTI_TP_LR))
    policy = DispatchConfig.from_arch(cfg)
    out = {"cfg": cfg, "params": fparams, "tokens": tokens, "targets": targets}

    def step(m, p):
        state = TrainState(params=p, opt_state=opt.init(p), step=torch.zeros((), dtype=torch.int32))
        with use_dispatch(policy):
            new, metrics = make_train_step(m, opt)(state, batch)
        return new.params, {k: float(v) for k, v in metrics.items()}

    out["bf16"] = step(fmodel, fparams)
    to32 = lambda t: {k: to32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()  # noqa: E731
    out["fp32"] = step(build_model(dataclasses.replace(cfg, dtype="float32")), to32(fparams))
    with torch.no_grad(), use_dispatch(policy):
        out["greedy"] = greedy_generate(fmodel, fparams, {"tokens": batch["tokens"]}, steps=MULTI_TP_DECODE + 1,
                                        max_len=S + MULTI_TP_DECODE).cpu()
        logits, cache = fmodel.prefill(fparams, {"tokens": batch["tokens"]}, S + MULTI_TP_DECODE)
        steps = [logits.float().cpu()]
        for i in range(MULTI_TP_DECODE):
            logits, cache = fmodel.decode_step(fparams, cache, out["greedy"][:, i:i + 1].cuda(), S + i)
            steps.append(logits.float().cpu())
    out["logits"] = steps
    return out


def tp_gates(outs, ref, dry_counts, specs) -> dict:
    """(f)'s gates.  (i) The train step against the single card's: its loss
    and grad norm within 1.5 x the single card's bf16 distance from the fp32
    step plus 1e-3 of the fp32 value; the params assembled from the ranks'
    blocks, their update (new - old) against the fp32 step's: the RMS error
    within 1.2 x the single card's bf16 update's, the largest within 1.5 x
    (phases 19-20's fp32-anchored rule).  (ii) The greedy tokens equal the
    single card's ``greedy_generate``, and every step's logits within 5e-2 of
    max |logit| of its (phase 29 (b)'s bf16 tolerance).  (iii) Each rank's
    argument bytes as the caching allocator counts them (the bytes
    requested) within 1 MiB of its dry count, the train step's allocated
    bytes within 1 % of it (phase 30's rule), and its collectives (bytes by
    axis, their count) equal to the dry mesh's record, for the train,
    prefill and decode steps; its tensors' storages are printed beside
    them.  Each kernel of MULTI_TP_KERNELS launched."""
    import torch

    from repro_torch.runtime.distributed import MeshSpec, assemble
    from repro_torch.tree import tree_paths

    res = {}
    f0 = outs[0]["f"]
    m32, mb = ref["fp32"][1], ref["bf16"][1]
    for k in ("loss", "grad_norm"):
        got = [o["f"]["metrics"][k] for o in outs]
        tol = 1.5 * abs(mb[k] - m32[k]) + 1e-3 * abs(m32[k])
        res[k] = {"tp": got[0], "single_bf16": mb[k], "fp32": m32[k], "tol": tol}
        if any(abs(g - m32[k]) > tol for g in got) or len(set(got)) != 1:
            fail(f"phase 29 (f) (i): {k} {got} against the fp32 step's {m32[k]} (tol {tol:.3e}; the single card's "
                 f"bf16 {mb[k]})")
    mesh = MeshSpec(MULTI_MESH, ("data", "model"))
    old = dict(tree_paths(ref["params"]))
    new32, newb = dict(tree_paths(ref["fp32"][0])), dict(tree_paths(ref["bf16"][0]))
    num = {"tp": 0.0, "single": 0.0}
    top = {"tp": 0.0, "single": 0.0}
    n = 0
    worst = (None, 0.0)
    for path, sp in tree_paths(specs):
        got = assemble([o["f"]["params"][path] for o in outs], sp, mesh).float()
        o32 = old[path].float().cpu()
        d32 = new32[path].float().cpu() - o32
        e_tp = (got - o32) - d32
        e_s = (newb[path].float().cpu() - o32) - d32
        num["tp"] += float(e_tp.pow(2).sum())
        num["single"] += float(e_s.pow(2).sum())
        top["tp"], top["single"] = max(top["tp"], float(e_tp.abs().max())), max(top["single"], float(e_s.abs().max()))
        n += got.numel()
        r = float(e_tp.pow(2).mean().sqrt()) / max(float(e_s.pow(2).mean().sqrt()), 1e-30)
        if r > worst[1]:
            worst = (path, r)
    ratios = {"rms": (num["tp"] / max(num["single"], 1e-30)) ** 0.5, "max": top["tp"] / max(top["single"], 1e-30)}
    res["update_vs_fp32"] = {"ratios": ratios, "max_err": top, "elements": n, "worst_leaf_rms_ratio": worst}
    if not (ratios["rms"] <= 1.2 and ratios["max"] <= 1.5):
        fail(f"phase 29 (f) (i): the assembled update against the fp32 step's is {ratios} x the single card's "
             "(tol RMS 1.2, largest 1.5)")

    # (ii): the ranks' tokens over "data" rows, against the single card's
    toks = torch.cat([outs[d * MULTI_MESH[1]]["f"]["tokens"] for d in range(MULTI_MESH[0])])
    for o in outs:
        row = o["rank"] // MULTI_MESH[1]
        if not torch.equal(o["f"]["tokens"], outs[row * MULTI_MESH[1]]["f"]["tokens"]):
            fail(f"phase 29 (f) (ii): rank {o['rank']}'s tokens differ from its data row's")
    same = int((toks == ref["greedy"]).sum())
    errs = []
    for i, want in enumerate(ref["logits"]):
        got = torch.cat([outs[d * MULTI_MESH[1]]["f"]["logits"][i] for d in range(MULTI_MESH[0])])
        errs.append(float((got - want).abs().max()) / float(want.abs().max()))
    res["generate"] = {"tokens_equal": same, "tokens": toks.numel(), "logits_rel_err": errs,
                       "cache_shapes": f0["cache_shapes"]}
    if same != toks.numel() or max(errs) > 5e-2:
        fail(f"phase 29 (f) (ii): {same} of {toks.numel()} greedy tokens equal the single card's; logits "
             f"{max(errs):.3e} x max |logit| (tol 5e-2)")

    # (iii): each rank's counts against the dry count (of rank 0; every rank's blocks are alike)
    res["counts"] = {}
    for o in outs:
        for step in ("train", "prefill", "decode"):
            requested, live = o["f"]["alloc"][step], o["f"]["colls"][step]
            want = dry_counts[step]
            dry_args = want["argument_bytes"]
            allocated = o["f"]["alloc"]["train_allocated"] if step == "train" else None
            if o["rank"] in (0, 5):
                res["counts"][f"rank {o['rank']} {step}"] = {
                    "allocator_requested_bytes": requested, "allocator_allocated_bytes": allocated,
                    "storage_bytes": o["f"]["args"][step], "dry_argument_bytes": dry_args,
                    "by_axis": live["by_axis"], "by_kind": live["by_kind"], "ops": live["ops"]}
            same_axes = set(live["by_axis"]) == set(want["by_axis"]) and all(
                abs(live["by_axis"][a] - want["by_axis"][a]) <= 1e-9 * max(1.0, want["by_axis"][a])
                for a in want["by_axis"])
            if abs(requested - dry_args) > MULTI_TP_ARG_SLACK or not same_axes or live["ops"] != want["ops"] \
                    or (allocated is not None and abs(allocated - dry_args) > MULTI_TP_ALLOC_REL * dry_args):
                fail(f"phase 29 (f) (iii) rank {o['rank']} {step}: the allocator's requested bytes {requested} "
                     f"(allocated {allocated}; storages {o['f']['args'][step]}) against the dry count's {dry_args}, "
                     f"collectives {live} against {want}")
    launches = {n: sum(o["launches"][p][n] for o in outs for p in ("f_train", "f_generate"))
                for n in MULTI_TP_KERNELS}
    res["launches"] = launches
    if any(c <= 0 for c in launches.values()):
        fail(f"phase 29 (f): kernels never launched on the tensor-parallel path: {launches}")
    return res


def _tree_blocks(tree, mesh, rank, prefix=""):
    """A stacked (L, ...) subtree's leaves cut to this rank's stage on ("pod",) (views)."""
    from repro_torch.runtime.distributed import local_block

    if isinstance(tree, dict):
        return {k: _tree_blocks(v, mesh, rank) for k, v in tree.items()}
    return local_block(tree, ("pod",), mesh, rank)


def multi_nccl(mesh, W, omega) -> dict:
    """(a) once more at mesh (1, 1), world 1, under nccl: the NCCL path
    initializes and computes (every psum is over an axis of one rank)."""
    from repro_torch.core.distributed_rsi import distributed_rsi

    t = time.perf_counter()
    res = distributed_rsi(W, MULTI_RSI_K, MULTI_RSI_Q, omega=omega)
    return {"err": _rsi_errors(W, res, mesh), "backend": mesh.backend, "seconds": time.perf_counter() - t}


def compute_mode() -> str:
    """The card's compute mode as nvidia-smi prints it, or what went wrong."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode == 0 and res.stdout.strip():
        return res.stdout.strip().splitlines()[0]
    return f"nvidia-smi exited {res.returncode}: stdout {res.stdout.strip()!r}, stderr {res.stderr.strip()[-300:]!r}"


def phase_multi(model, params, runs: dict) -> dict:
    """Phase 29: the multi-device layer on eight gloo ranks sharing the card.

    The inputs are built here, once, and reach the ranks as CUDA IPC handles
    (no copies); the single-rank references run here too.  Gates: (a)
    ||W - U S Vt||_F of the distributed RSI within 1e-3 (relative) of the
    single-rank ``rsi``'s on the same W and Omega (fp32 products on both),
    the decaying spectrum's reconstruction within 1e-4 of the single rank's,
    U on ("data", None) and Vt on (None, "model") (block shapes, and bits
    equal across the replicating axis), and the same at (1, 1) under nccl;
    (b) the EP layer within 1e-4 of max |y| (fp32) and 5e-2 (bf16, phase
    5's) of the single-rank moe_forward, over tokens routed alike; (c) the
    pipeline bit for bit the sequential forward over the same
    microbatches, and within 5e-2 of max |y| of the whole-batch forward,
    and its backward (autograd through the shifts and the psum) giving
    each stage's slice within 5e-2 of max |g| of the single rank's
    gradient over the same microbatches, leaf by leaf;
    (d) PowerSGD's mean correlated > 0.7 with the dense mean on every
    matrix, its bytes < dense / 3; (e) the reshard bit for bit; (f) the
    tensor-parallel program's step, prefill and greedy decode against the
    single card and its counts against the dry mesh's (:func:`tp_gates`);
    and each kernel of the path launched on the ranks."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, rsi, synth_spectrum_matrix, vgg_like_spectrum
    from repro_torch.core.rsi import QR_FALLBACKS
    from repro_torch.models import moe
    from repro_torch.models import modules as nn
    from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
    from repro_torch.runtime.distributed import spawn
    from repro_torch.tree import tree_map

    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the ranks allocate on the same card: return this process's cached blocks
    t_phase = time.perf_counter()
    card = card_line()
    mode = compute_mode()
    say(f"[multi] {card}; compute mode {mode}; {MULTI_WORLD} gloo ranks on cuda:0, mesh {MULTI_MESH}")
    if mode != "Default":
        fail(f"phase 29: compute mode {mode!r}: several processes share the card only in Default mode")
    dev = torch.device("cuda")
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    secs = {}

    def sync_time(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t
        return r

    # (a)'s inputs and single-rank references
    qcfg = get_arch("qwen2-72b")
    C, D = qcfg.d_model, qcfg.d_ff
    W_qwen = sync_time("a_build", lambda: nn.dense_init(gen(0), C, D, torch.bfloat16, dev))
    W_spec = sync_time("a_build_spectral", lambda: synth_spectrum_matrix(
        C, D, vgg_like_spectrum(C, device=dev), generator=gen(3), device=dev))
    omega = torch.randn((D, MULTI_RSI_K), generator=gen(1), dtype=torch.float32, device=dev)
    single = {}
    for key, W in (("qwen", W_qwen), ("spectral", W_spec)):
        QR_FALLBACKS.reset()
        res = sync_time(f"a_single_{key}", lambda: rsi(W.float(), MULTI_RSI_K, MULTI_RSI_Q, omega=omega))
        w = W.float()
        err = float(torch.linalg.norm(w - (res.U * res.S[None]) @ res.Vt) / torch.linalg.norm(w))
        single[key] = {"res": res, "err": err, "fallbacks": QR_FALLBACKS.count}
        del w
    # (b)'s layer: one phi3.5-moe MoE block at full width, compressed at alpha 0.3, q 4
    mcfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"), capacity_factor=MULTI_MOE_CF)
    moe_p = moe.moe_init(gen(4), mcfg, torch.bfloat16, dev)
    moe_p = sync_time("b_compress", lambda: compress_tree({"moe": moe_p}, CompressionPolicy(alpha=ALPHA, q=4,
                                                                                              min_dim=32),
                                                          generator=gen(5))[0]["moe"])
    f32 = lambda t: {k: f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()  # noqa: E731
    moe_p32 = f32(moe_p)
    x_moe = torch.randn(MULTI_MOE_TOKENS + (mcfg.d_model,), generator=gen(6), device=dev).to(torch.bfloat16)
    moe_ref = {}
    for tag, p, xx in (("fp32", moe_p32, x_moe.float()), ("bf16", moe_p, x_moe)):
        y, _ = sync_time(f"b_single_{tag}", lambda: moe.moe_forward(p, xx, mcfg))
        ids = moe._route(xx.reshape(-1, xx.shape[-1]), p["router"]["gate_w"], mcfg)[0]
        moe_ref[tag] = (y, ids)
    rank_ = moe_p["experts"]["w_gate"]["a"].shape[-1]
    # (c)'s inputs: the q = 4 llama3.2-1b's layers and the embedded batch; the references
    lcfg = model.cfg
    toks = torch.randint(0, lcfg.vocab, MULTI_PIPE_BATCH, generator=gen(7), device=dev)
    x0 = nn.embed_lookup(params["embed"], toks)
    layers = params["layers"]
    L = layers["attn_norm"]["scale"].shape[0]
    from repro_torch.models import lm

    def sequential(x):
        with torch.no_grad(), use_dispatch(DispatchConfig.from_arch(lcfg)):
            for i in range(L):
                x = pipe_block(lm._layer(layers, i), x, lcfg)
        return x

    b = MULTI_PIPE_BATCH[0] // MULTI_PIPE_MICROBATCHES
    seq = sync_time("c_sequential", lambda: torch.cat([sequential(x0[j * b:(j + 1) * b])
                                                       for j in range(MULTI_PIPE_MICROBATCHES)]))
    whole = sync_time("c_whole", lambda: sequential(x0))
    # (c)'s backward reference: the gradient of <y, wo> over the same microbatches, one rank
    wo = torch.randn(tuple(x0.shape), generator=gen(8), device=dev)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), layers)

    def seq_backward():
        with use_dispatch(DispatchConfig.from_arch(lcfg)):
            for j in range(MULTI_PIPE_MICROBATCHES):
                x = x0[j * b:(j + 1) * b]
                for i in range(L):
                    x = pipe_block(lm._layer(live, i), x, lcfg)
                torch.sum(x.float() * wo[j * b:(j + 1) * b]).backward()
        return tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), live)

    pipe_grads = sync_time("c_backward_sequential", seq_backward)
    del live

    # (f)'s single-card references, and its dry counts on rank 0 (CPU fakes; every rank's blocks, and
    # so its arguments and collectives, are alike)
    tp_ref = sync_time("f_single", lambda: tp_references(model, params))
    tp_dry = sync_time("f_dry", lambda: tp_dry_counts(tp_ref["cfg"], tp_ref["params"], 0))

    inp = {"W_qwen": W_qwen, "W_spectral": W_spec, "omega": omega, "single_U": single["spectral"]["res"].U,
           "single_S": single["spectral"]["res"].S, "single_Vt": single["spectral"]["res"].Vt,
           "moe_cfg": mcfg, "moe_p": moe_p, "moe_p32": moe_p32, "moe_x": x_moe,
           "llama_cfg": lcfg, "llama_layers": layers, "llama_x0": x0, "pipe_wo": wo, "pipe_grads": pipe_grads,
           "tp_cfg": tp_ref["cfg"], "tp_params": tp_ref["params"], "tp_tokens": tp_ref["tokens"],
           "tp_targets": tp_ref["targets"]}
    say(f"[multi] inputs and single-rank references in {time.perf_counter() - t_phase:.1f}s: "
        + json.dumps({k: round(v, 3) for k, v in secs.items()}))
    ckpt_dir = tempfile.mkdtemp(prefix="phase29_ckpt_")
    try:
        t = time.perf_counter()
        outs = spawn(multi_ranks, MULTI_WORLD, MULTI_MESH, ("data", "model"), "cuda", inp, ckpt_dir,
                     backend="gloo", timeout_s=300)
        spawn_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    r0 = outs[0]
    summary = {"card": card, "compute_mode": mode, "spawn_s": spawn_s, "rank0_s": r0["seconds"],
               "allreduce": r0["allreduce"]}

    # (a) gates
    for key in ("qwen", "spectral"):
        errs = [o[f"a_{key}"]["err"] for o in outs]
        e1 = single[key]["err"]
        rel = abs(errs[0] - e1) / e1
        summary[f"a_{key}"] = {"err": errs[0], "single_err": e1, "rel": rel,
                               "fallbacks": [o[f"a_{key}"]["fallbacks"] for o in outs],
                               "single_fallbacks": single[key]["fallbacks"]}
        if rel > 1e-3 or not all(e == errs[0] for e in errs):
            fail(f"phase 29 (a) {key}: ||W - USVt|| / ||W|| {errs} against the single rank's {e1} (rel {rel:.2e})")
        for o in outs:
            c = {"data": o["rank"] // MULTI_MESH[1], "model": o["rank"] % MULTI_MESH[1]}
            a = o[f"a_{key}"]
            if a["U_shape"] != (C // MULTI_MESH[0], MULTI_RSI_K) or a["Vt_shape"] != (MULTI_RSI_K, D // MULTI_MESH[1]):
                fail(f"phase 29 (a) {key}: rank {o['rank']} holds U {a['U_shape']}, Vt {a['Vt_shape']}")
            if a["U_sha"] != outs[c["data"] * MULTI_MESH[1]][f"a_{key}"]["U_sha"] or \
                    a["Vt_sha"] != outs[c["model"]][f"a_{key}"]["Vt_sha"] or a["S_sha"] != r0[f"a_{key}"]["S_sha"]:
                fail(f"phase 29 (a) {key}: rank {o['rank']}'s blocks differ from their replicas'")
    summary["a_spectral"]["recon_rel"] = r0["a_spectral"]["recon_rel"]
    if not r0["a_spectral"]["recon_rel"] < 1e-4:
        fail(f"phase 29 (a): the decaying spectrum's reconstruction {r0['a_spectral']['recon_rel']:.2e} from the "
             "single rank's (limit 1e-4)")
    t = time.perf_counter()
    nccl = spawn(multi_nccl, 1, (1, 1), ("data", "model"), "cuda", W_qwen, omega, backend="nccl", timeout_s=300)[0]
    nccl["spawn_s"] = time.perf_counter() - t
    nccl["rel"] = abs(nccl["err"] - single["qwen"]["err"]) / single["qwen"]["err"]
    summary["a_nccl_world1"] = nccl
    if nccl["backend"] != "nccl" or nccl["rel"] > 1e-3:
        fail(f"phase 29 (a) under nccl at (1, 1): {nccl}")

    # (b) gates, over the tokens every run routes alike
    for tag, tol in (("fp32", 1e-4), ("bf16", 5e-2)):
        want, want_ids = moe_ref[tag]
        got = torch.cat([outs[i * MULTI_MESH[1]][f"b_{tag}"]["y"] for i in range(MULTI_MESH[0])]).to(dev)
        ids = torch.cat([outs[i * MULTI_MESH[1]][f"b_{tag}"]["ids"] for i in range(MULTI_MESH[0])]).to(dev)
        same = (ids.sort(-1).values == want_ids.sort(-1).values).all(-1).reshape(MULTI_MOE_TOKENS)
        err = float((got.float() - want.float()).abs()[same].max())
        scale = float(want.float().abs().max())
        flips = int((~same).sum())
        summary[f"b_{tag}"] = {"max_abs_err": err, "max_abs_y": scale, "rel": err / scale, "routing_flips": flips,
                               "aux": [o[f"b_{tag}"]["aux"] for o in outs][:: MULTI_MESH[1]],
                               "batched_launches_per_rank": [o["launches"][f"b_{tag}"]["lowrank_matmul_batched"]
                                                             for o in outs]}
        if err > tol * scale or flips > 2:
            fail(f"phase 29 (b) {tag}: EP against the single rank {err:.3e} (limit {tol} x {scale:.3e}), "
                 f"{flips} tokens routed otherwise")
        for o in outs:
            if o[f"b_{tag}"]["y_sha"] != outs[o["rank"] // MULTI_MESH[1] * MULTI_MESH[1]][f"b_{tag}"]["y_sha"]:
                fail(f"phase 29 (b) {tag}: rank {o['rank']}'s output differs from its data row's")
    summary["b_rank"] = rank_

    # (c) gates
    got = r0["c"]["y"].to(dev)
    if not all(o["c"]["y_sha"] == r0["c"]["y_sha"] for o in outs):
        fail("phase 29 (c): the stages' outputs differ")
    if not torch.equal(got, seq):
        fail(f"phase 29 (c): the pipeline is not the sequential forward bit for bit "
             f"(max abs {float((got.float() - seq.float()).abs().max()):.3e})")
    err = float((got.float() - whole.float()).abs().max())
    scale = float(whole.float().abs().max())
    summary["c"] = {"bitwise_sequential": True, "whole_batch_max_abs_err": err, "max_abs_y": scale,
                    "whole_batch_bitwise": bool(torch.equal(got, whole))}
    if err > 5e-2 * scale:
        fail(f"phase 29 (c): the pipeline {err:.3e} from the whole-batch forward (limit 5e-2 x {scale:.3e})")
    worst = [o["c_backward"]["worst"] for o in outs]
    summary["c_backward"] = {"worst_leaf_per_rank": worst, "leaves": r0["c_backward"]["leaves"]}
    for path, (e, sc) in worst:
        if not e <= 5e-2 * sc:
            fail(f"phase 29 (c) backward: {path}'s gradient {e:.3e} from the single rank's (limit 5e-2 x {sc:.3e})")

    # (d) gates
    corr = r0["d"]["corr"]
    dense_b, comp_b = r0["d"]["bytes"]
    summary["d"] = {"corr_min": min(corr.values()), "corr": corr, "dense_bytes": dense_b, "compressed_bytes": comp_b}
    if min(min(o["d"]["corr"].values()) for o in outs) <= 0.7 or not comp_b < dense_b / 3:
        fail(f"phase 29 (d): PowerSGD correlation {corr}, bytes {comp_b} of {dense_b}")

    # (e) gates
    summary["e"] = {"U_shape": r0["e"]["U_shape"], "Vt_shape": r0["e"]["Vt_shape"]}
    if not all(o["e"]["U"] and o["e"]["S"] and o["e"]["Vt"] for o in outs):
        fail("phase 29 (e): the blocks restored onto (8, 1) differ from the saved ones")

    # (f) gates
    from repro_torch.runtime.distributed import MeshSpec
    from repro_torch.sharding.rules import MeshRules, layout_specs

    tp_specs = layout_specs(tp_ref["params"], MeshRules(MeshSpec(MULTI_MESH, ("data", "model"))))
    summary["f"] = tp_gates(outs, tp_ref, tp_dry, tp_specs)
    summary["f"]["rank0_s"] = {k: r0["seconds"][k] for k in ("f_train", "f_generate")}
    runs["tensor-parallel ranks"] = summary["f"]["launches"]
    del tp_ref, tp_dry

    launches = {n: sum(o["launches"][p][n] for o in outs for p in o["launches"]) for n in MULTI_KERNELS}
    runs["multi-device ranks"] = launches
    summary["launches"] = launches
    summary["launches_rank0"] = r0["launches"]
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        fail(f"phase 29: kernels never launched on the ranks: {missing}")
    summary["phase_s"] = time.perf_counter() - t_phase
    say("[multi] " + json.dumps(summary))
    say(f"[multi] phase 29 in {summary['phase_s']:.1f}s (spawn of {MULTI_WORLD} ranks and (a)-(e) {spawn_s:.1f}s, "
        f"nccl world 1 {nccl['spawn_s']:.1f}s); {card}; the ranks time-share one card: no multi-card figure")
    return summary


# --------------------------------------------------------------------------- #
# phase 30: the dry-run's counts against the card
# --------------------------------------------------------------------------- #
# the peak's tolerance: the dry world counts each live storage's bytes; the card's allocator rounds each
# block up to 512 B, keeps cuBLAS's workspaces in its count, and the kernels allocate their own outputs
# and scratch where the dry world runs their plain versions uncounted (PERF.md, section 6)
DRYRUN_PEAK_REL = 0.10
DRYRUN_ARG_REL = 0.01  # the arguments: the same tensors on both sides, plus cuBLAS's workspaces
DRYRUN_FLOP_REL = 0.01  # the matmul FLOPs: the same torch ops on both sides


# (a)'s steps: (name, tokens a row, rows, kind, a prefill's max_len)
DRYRUN_STEPS = (("phase 28 train", PROMPT, 8, "train", None), ("phase 3 prefill", PROMPT, BATCH, "prefill", PROMPT + GEN),
                ("decode", PROMPT + GEN, BATCH, "decode", None))


def dryrun_count(i: int) -> tuple:
    """(OpStats, seconds) of (a)'s step ``i`` counted on fakes in the dry
    world (run in a worker process: it needs no card)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun

    name, seq, rows, kind, max_len = DRYRUN_STEPS[i]
    st, _, _, t_build, t_run = dryrun.count_cell("llama3.2-1b", ShapeCell(name, seq, rows, kind), None,
                                                 max_len=max_len)
    return st, t_build + t_run


def dryrun_cell() -> tuple:
    """(record, seconds) of (b): llama3.2-1b train_4k on the dry 16 x 16 mesh."""
    from repro_torch.launch import dryrun

    t = time.perf_counter()
    r = dryrun.run_cell("llama3.2-1b", "train_4k", multi_pod=False, save=False)
    return r, time.perf_counter() - t


def phase_dryrun() -> dict:
    """Phase 30: the dry-run's per-step counts against the same steps run on
    the card, then one production cell on the dry 16 x 16 mesh.  The dry
    counts need no card: they run in worker processes while the card runs
    the steps."""
    import gc
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.runtime import dispatch

    t_phase = time.perf_counter()
    card = card_line()
    tag = f"[dryrun {card}]"
    cfg = get_arch("llama3.2-1b")
    out = {}
    with ProcessPoolExecutor(max_workers=len(DRYRUN_STEPS) + 1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cell_job = pool.submit(dryrun_cell)
        step_jobs = [pool.submit(dryrun_count, i) for i in range(len(DRYRUN_STEPS))]
        card_runs = []
        for name, seq, rows, kind, max_len in DRYRUN_STEPS:
            # what earlier phases left allocated is no part of the step: its bytes are counted from here
            gc.collect()
            torch._C._cuda_clearCublasWorkspaces()  # nor are cuBLAS's workspaces (32 MiB a handle)
            base = torch.cuda.memory_allocated()
            step, args, _, _ = dryrun.build_step(cfg, ShapeCell(name, seq, rows, kind), None, device="cuda",
                                                 max_len=max_len)
            step()  # warm: the kernels' first launches
            torch.cuda.synchronize()
            gc.collect()
            torch._C._cuda_clearCublasWorkspaces()
            alloc = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_counters()
            with FlopCounterMode(display=False) as fc:
                res = step()
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            calls = dispatch.kernel_calls()
            del res
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            card_runs.append((alloc, peak, calls, float(fc.get_total_flops()), device_busy_ms(prof), base))
            del step, args, prof
            gc.collect()
            torch.cuda.empty_cache()
        for (name, *_), (alloc, peak, calls, matmul, busy, base), job in zip(DRYRUN_STEPS, card_runs, step_jobs):
            st, dry_s = job.result()
            rf = roofline_terms(flops=st.flops, hbm_bytes=st.hbm_bytes, coll_bytes=0.0, chips=1,
                                model_flops_global=0.0)
            roof_ms = max(rf.t_compute, rf.t_memory) * 1e3
            dry_calls = {k: v["calls"] for k, v in st.kernels.items()}
            rec = {"step": name, "allocated_before_build": base,
                   "argument_bytes": {"dry": st.argument_bytes, "card": alloc},
                   "peak_bytes": {"dry": st.peak_bytes, "card": peak},
                   "kernel_calls": {"dry": dry_calls, "card": calls},
                   "matmul_flops": {"dry": st.matmul_flops, "card": matmul},
                   "flops": st.flops, "hbm_bytes": st.hbm_bytes,
                   "t_compute_ms": rf.t_compute * 1e3, "t_memory_ms": rf.t_memory * 1e3,
                   "device_busy_ms": busy, "roofline_over_measured": roof_ms / busy if busy else None,
                   "dry_s": dry_s}
            say(f"{tag} " + json.dumps(rec))
            if abs(alloc - st.argument_bytes) > DRYRUN_ARG_REL * st.argument_bytes:
                fail(f"{tag} {name}: {alloc} bytes allocated before the step, the dry-run's arguments "
                     f"{st.argument_bytes} (tolerance {DRYRUN_ARG_REL})")
            if abs(peak - st.peak_bytes) > DRYRUN_PEAK_REL * st.peak_bytes:
                fail(f"{tag} {name}: peak {peak} bytes on the card, {st.peak_bytes} in the dry-run "
                     f"(tolerance {DRYRUN_PEAK_REL})")
            if calls != dry_calls:
                fail(f"{tag} {name}: kernel calls on the card {calls}, in the dry-run {dry_calls}")
            if abs(matmul - st.matmul_flops) > DRYRUN_FLOP_REL * st.matmul_flops:
                fail(f"{tag} {name}: matmul FLOPs {matmul:.6e} on the card, {st.matmul_flops:.6e} in the dry-run")
            out[name] = rec
        r, cell_s = cell_job.result()
    brief = {k: r[k] for k in ("arch", "shape", "mesh", "rows_per_rank", "flops_per_chip", "hbm_bytes_per_chip",
                               "collectives_by_axis", "collective_rate_by_axis", "t_compute", "t_memory",
                               "t_collective", "bottleneck", "peak_bytes", "fits", "sharded_by_reference_bytes",
                               "kernels", "card")}
    brief.update(tensor_parallel=r["tensor_parallel"], collectives_by_kind=r["collectives_by_kind"],
                 argument_bytes=r["argument_bytes"])
    say(f"{tag} (b) llama3.2-1b train_4k on the dry 16 x 16 mesh in {cell_s:.1f}s: " + json.dumps(brief))
    say(f"{tag} (b) the tensor-parallel step's collectives a rank (FSDP gathers over data, the sequence's gathers "
        "and reduce-scatters over model, the gradient mean over data), bytes by axis: "
        + json.dumps(r["collectives_by_axis"]) + f"; priced at {HW.NAME}'s data-sheet rates")
    # the tensor-parallel count: the rank holds its blocks (1/256 of each 2-D leaf), nothing whole that the
    # reference splits, and the cell fits
    if not (r["tensor_parallel"] and r["sharded_by_reference_bytes"] == 0 and r["fits"]):
        fail(f"{tag} (b): the cell is not the tensor-parallel program's ({brief})")
    out["b"] = brief
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase 30 in {out['phase_s']:.1f}s")
    return out


def phase_dryrun_only() -> int:
    """``--dryrun-only``: phase 30 alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[dryrun-only] {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    say(f"[dryrun-only] build in {time.perf_counter() - t:.1f}s")
    phase_dryrun()
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def phase_multi_only() -> int:
    """``--multi-only``: phase 29 alone (on the q = 4 llama3.2-1b of phase 3)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from repro_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[multi-only] {card_line()}; package tree {SRC}")
    t = time.perf_counter()
    build_all()
    model, params = stage4_model()
    say(f"[multi-only] build and the q = 4 llama3.2-1b in {time.perf_counter() - t:.1f}s")
    phase_multi(model, params, {})
    say(f"[multi-only] in {time.perf_counter() - t:.1f}s")
    say(card_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


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
    if "--paper-only" in sys.argv:
        return phase_paper_only()
    if "--sharing-only" in sys.argv:
        return phase_sharing_only()
    if "--overload-only" in sys.argv:
        return phase_overload_only()
    if "--chunk-only" in sys.argv:
        return phase_chunk_only()
    if "--cluster-only" in sys.argv:
        return phase_cluster_only()
    if "--h2o-only" in sys.argv:
        return phase_h2o_only()
    if "--deepseek-only" in sys.argv:
        return phase_deepseek_only()
    if "--vlm-only" in sys.argv:
        return phase_modal_only(VLM_ARCH)
    if "--whisper-only" in sys.argv:
        return phase_modal_only(WHISPER_ARCH)
    if "--train-only" in sys.argv:
        return phase_train_only()
    if "--multi-only" in sys.argv:
        return phase_multi_only()
    if "--dryrun-only" in sys.argv:
        return phase_dryrun_only()
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
            if name == "flash_attention":
                say(f"[ptxas flash_attention instances] {ptxas_flash_instances(log.read_text())}")
    for name, opcodes in REDESIGNED.items():
        for opcode in opcodes:
            n = sass_count(built[name], opcode)
            say(f"[sass {name}] " + ("cuobjdump not found" if n is None else f"{opcode} instructions: {n}"))
            if n == 0:
                fail(f"{name}: no {opcode} instruction in the built library")
    time_ms.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    t = time.perf_counter()
    records, phi, g1, dense = phase_kernels()
    phase_grad_kernels(records)
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
    # phase 21 (engine stage 4) runs here, on the same q = 4 model, before it is freed
    t = time.perf_counter()
    phase_stage4(model, params_q4)
    say(f"[stage4] phase 21 in {time.perf_counter() - t:.1f}s")
    # phases 26-27 (the replicated cluster, then the examples and kernels/ops.py) on the same model
    cluster = phase_cluster(model, params_q4)
    runs["llama3.2-1b cluster"] = cluster["launches_i"]
    examples = phase_examples()
    say(f"[cluster] phase 26 in {cluster['phase_s']:.1f}s, phase 27 in {examples['phase_s']:.1f}s, together "
        f"{cluster['phase_s'] + examples['phase_s']:.1f}s: " + json.dumps({"26": cluster, "27": examples}))
    # phase 28 (training) on the same q = 4 model, then mamba2-130m through the launcher
    phase_train(model, params_q4, runs)
    # phase 29 (the multi-device layer on eight ranks sharing the card), its pipeline on the same model
    phase_multi(model, params_q4, runs)
    gc.collect()
    torch.cuda.empty_cache()
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
        summary["reference"] = phase_deep_reference(model, params, batch, tag=f"{tag} reference")
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

    # phase 18: the paper's experiments (sketch_matmul on every power iteration, lowrank_matmul
    # on Table 4.1's compressed forwards)
    t = time.perf_counter()
    phase_paper(runs, records)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[paper] phase 18 in {time.perf_counter() - t:.1f}s")

    # phases 19-20: minitron-4b at 16 of 32 layers and qwen2-72b at 8 of 80, then prefix sharing
    t = time.perf_counter()
    phase_dense(runs)
    say(f"[dense] phases 19-20 in {time.perf_counter() - t:.1f}s")

    # phase 22: h2o-danube-1.8b whole, the sliding-window ring (its model freed inside)
    t = time.perf_counter()
    phase_h2o(runs)
    say(f"[h2o] phase 22 in {time.perf_counter() - t:.1f}s")

    # phase 23: deepseek-v2-236b at 3 of 60 layers, MLA (its model freed inside)
    t = time.perf_counter()
    phase_deepseek(runs)
    say(f"[deepseek] phase 23 in {time.perf_counter() - t:.1f}s")

    # phases 24-25: llama-3.2-vision-11b and whisper-small whole (each model freed inside)
    for arch in MODAL_ARCHS:
        t = time.perf_counter()
        phase_modal(arch, runs)
        say(f"[{MODAL_TAGS[arch]}] phase {MODAL_PHASES[arch]} in {time.perf_counter() - t:.1f}s")

    # phase 30: the dry-run's counts against the card, then one production cell on the dry mesh
    phase_dryrun()
    gc.collect()
    torch.cuda.empty_cache()

    # `launches`: the kernel's count on the main run of the newest engine path that runs it (the
    # shape and dtype of its `ms`); phase 18's fp32 paper runs stand only in `launches_by_run`, and
    # phases 19-20's runs there and beside the records of their own shapes below
    newest_first = ["zamba2-1.2b engine", "mamba2-130m engine",
                    "zamba2-1.2b flat engine", "phi3.5-moe engine",
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
        # 1024; the batched kernel at the decode and the skewed occupancy; phase 18's fp32
        # shapes (the sketch GEMM on Fig 4.1's W, the low-rank kernel on Table 4.1's fc1)
        subs = (("hd128", phi, name), ("g1", g1, name), ("trans_a", records, f"{name} trans_a"),
                ("lse", records, f"{name} lse"),
                ("logits", records, f"{name} logits"), ("untied_head", records, f"{name} untied head"),
                ("m8", records, f"{name} M 8"), ("m256", records, f"{name} M 256"),
                ("m1024", records, f"{name} M 1024"), ("decode_occupancy", records, f"{name} decode"),
                ("fig4_1_k50", records, f"{name} fig4_1 k 50"),
                ("fig4_1_k50_trans_a", records, f"{name} fig4_1 k 50 trans_a"),
                ("fig4_1_k200", records, f"{name} fig4_1 k 200"),
                ("fig4_1_k200_trans_a", records, f"{name} fig4_1 k 200 trans_a"),
                ("table4_1", records, f"{name} table4_1"),
                ("skewed_occupancy", records, f"{name} skewed"),
                ("zamba2_4x256", records, f"{name} 4x256 nh 64 s 64 x̄ rounded"),
                ("mamba2_1x512", records, f"{name} 1x512 nh 24 s 128 x̄ rounded"),
                # phases 19-20's shapes: attention at G = 3 and G = 8 (head_dim 128), the low-rank
                # kernel at each model's w_gate, the sketch GEMM at qwen2's w_gate
                ("minitron_g3", dense["minitron-4b"], name), ("qwen2_g8", dense["qwen2-72b"], name),
                ("minitron_w_gate_m4", records, f"{name} minitron M 4"),
                ("minitron_w_gate_m8", records, f"{name} minitron M 8"),
                ("minitron_w_gate_m64", records, f"{name} minitron M 64"),
                ("qwen2_w_gate_m4", records, f"{name} qwen2 M 4"), ("qwen2_w_gate_m8", records, f"{name} qwen2 M 8"),
                ("qwen2_w_gate", records, f"{name} qwen2"), ("qwen2_w_gate_trans_a", records, f"{name} qwen2 trans_a"),
                # phase 22's shapes: h2o-danube's head_dim 80 at (4, 256), its window at (1, 16384), the
                # decode over a wrapped ring, its w_gate at M 4 and 8
                ("h2o_hd80", records, f"{name} h2o hd80"), ("h2o_window_16k", records, f"{name} h2o window 16k"),
                ("h2o_ring_wrapped", records, f"{name} h2o ring"),
                ("h2o_w_gate_m4", records, f"{name} h2o M 4"), ("h2o_w_gate_m8", records, f"{name} h2o M 8"),
                # phase 23's shapes: the MLA flash at q/k 192, v 128; the batched kernel over 160
                # experts (every row live, and top-6's decode occupancy); wo and wq_b at M 4 and 8;
                # the sketch GEMM at an expert's w_gate
                ("deepseek_mla", records, f"{name} deepseek mla"),
                ("deepseek_w_gate_full", records, f"{name} deepseek w_gate full"),
                ("deepseek_w_down_full", records, f"{name} deepseek w_down full"),
                ("deepseek_w_gate_decode", records, f"{name} deepseek w_gate decode"),
                ("deepseek_w_down_decode", records, f"{name} deepseek w_down decode"),
                ("deepseek_wo_m4", records, f"{name} deepseek wo M 4"),
                ("deepseek_wo_m8", records, f"{name} deepseek wo M 8"),
                ("deepseek_wq_b_m4", records, f"{name} deepseek wq_b M 4"),
                ("deepseek_wq_b_m8", records, f"{name} deepseek wq_b M 8"),
                ("deepseek_w_gate", records, f"{name} deepseek"),
                ("deepseek_w_gate_trans_a", records, f"{name} deepseek trans_a"),
                # phases 24-25's shapes: the flash kernel's non-causal path (whisper's encoder,
                # cross-attention at prefill and at Sq = 1, one key, 65 keys)
                *((label.replace(" ", "_"), records, f"{name} {label}") for label, *_ in NONCAUSAL_FLASH))
        for key, sub, rec_key in subs:
            if rec_key in sub:
                entry[key] = {k: sub[rec_key][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}
                arch = next((a for a in [a for a, _ in DENSE_ARCHS] + [H2O_ARCH, DEEPSEEK_ARCH]
                             if key.startswith(a.split("-")[0])), None)
                arch = arch or next((a for a, t in MODAL_TAGS.items() if key.startswith(t + "_")), None)
                if arch is not None:  # the count of the same model's run (the window trace's for the 16k prompt)
                    mine = ("window engine",) if key == "h2o_window_16k" else ("engine", "flat engine", "compression")
                    own = next((f"{arch} {r}" for r in mine if runs.get(f"{arch} {r}", {}).get(name, 0) > 0),
                               f"{arch} {mine[0]}")
                    entry[key].update(launches=runs.get(own, {}).get(name, 0), launches_run=own)
        # phase 2's training cases: the Function's forward (this kernel) beside its plain backward
        backward = [{k: r[k] for k in ("shape", "dtype", "fwd_ms", "bwd_ms", "plain_fwd_bwd_ms", "max_rel_err")}
                    for key, r in records.items() if key.startswith(f"{name} ") and " backward " in key]
        if backward:
            entry["backward"] = backward
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
