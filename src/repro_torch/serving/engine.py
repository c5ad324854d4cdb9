"""Continuous-batching serving engine over a slotted or PAGED KV-cache pool.

The port's counterpart of ``repro/serving/engine.py``.  The engine owns ONE
batched decode cache of ``n_slots`` rows and runs an admit -> prefill ->
fused-decode loop:

  * requests enter a FIFO queue (:mod:`repro_torch.serving.scheduler`) and
    take cache slots as slots free up; exhaustion queues, it never errors;
  * admitted requests are prefilled in right-padded micro-batches, bucketed
    to powers of two (causal masking keeps padded prefill exact), and
    their caches are scattered into the pool rows, or into their pages.
    The ssm and hybrid families group admissions by EXACT prompt length and
    never pad the length: right-padding would run the padding through the
    recurrent state;
  * ALL active slots then share one fused decode block: ``decode_block``
    iterations of decode step -> sample -> stop detection -> buffer update
    on the device, then ONE host round-trip that drains the emitted
    (tokens, mask) stack, finishes requests and admits waiting ones.

With ``page_size`` the per-token cache lives in a pool of ``kv_pages``
pages (plus one trash page) behind per-slot block tables: admission is
gated on a request's actual page need (zero where no cache leaf is paged,
as in mamba2, whose conv tails and states are slot rows), decode attention
walks the table
(the ``paged_decode_attention`` kernel), and with ``prefill_chunk`` long
prompts prefill one chunk per step, interleaved with decode blocks.  The
block table only relocates bytes: greedy tokens equal the flat engine's.

The fused block on the card.  The reference jits a ``lax.scan`` of decode
steps with the cache donated.  Here the per-slot buffers (tokens,
positions, activity, emitted counts, stop limits, sampling params and the
block table, packed into one int64 tensor) and the emit stacks are device
tensors at fixed addresses, and the block's ``decode_block`` iterations are
captured ONCE per sampling variant (greedy or not) as a CUDA graph, after an
eager warm-up on a side stream that also builds and loads every kernel
library.  A block is then one ``copy_`` of the host mirrors in, one
``replay()`` and one device-to-host drain.  On the CPU, and with
``cuda_graph=False``, the same body runs eagerly.  A capture that fails
raises: nothing falls back to eager decode.

Frozen slots (finished, empty, or still chunk-prefilling) re-feed their
last (token, position) pair, so their cache writes are idempotent (empty
and chunk-prefilling slots write to the trash page in paged mode) while
their emit mask keeps everything after the stop out of the results: the
emitted tokens are the same for ANY block size.  A frozen slot's recurrent
rows (mamba conv tails and state) do drift, as in the reference; rows are
independent across the batch, and the prefill scatter overwrites a reused
slot's rows whole.  A slot whose logits turn
non-finite freezes on that step; its request ends with ``status="error"``
and the rest of the batch decodes on.

Greedy determinism contract: with temperature 0 the engine emits, per
request, the tokens ``greedy_generate`` produces for that prompt alone.

Not in this slice of the port (each raises ``NotImplementedError``):
prefix sharing and the session cache (``share_prefix``,
``warm_cache_pages``), and the overload layer (``tiers``/``tier_q``,
``admission``, ``injector``, ``preempt``, ``watchdog``, ``on_event``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels._build import kernel_libs
from repro_torch.runtime import dispatch
from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
from repro_torch.serving.sampling import SamplingParams, sample_tokens, token_salts
from repro_torch.serving.scheduler import PageAllocator, PageGrant, Scheduler, SlotAllocator

__all__ = ["Request", "Engine", "SamplingParams", "percentile"]

# eos sentinel for the fused stop check when no eos token is configured:
# sampled token ids are always >= 0, so -1 never matches.
_NO_EOS = -1

# rows of the packed per-slot state (one int64 (rows, n_slots) tensor); the
# paged engine's block table follows, transposed, in rows _BT onwards
_TOK, _POS, _ACT, _EMIT, _MAXNEW, _SEED, _TOPK, _TEMP, _BT = range(9)

# Families whose decode state integrates every prefill token (recurrent and
# convolutional state): right-padding would corrupt it, so their admission
# micro-batches group by EXACT prompt length (repro/serving/engine.py:122-125).
_EXACT_LEN_FAMILIES = ("ssm", "hybrid")

_LATER = {
    "share_prefix": "the prefix-sharing and session-cache slice",
    "warm_cache_pages": "the prefix-sharing and session-cache slice",
    "tiers": "the overload slice (rank tiers)",
    "tier_q": "the overload slice (rank tiers)",
    "admission": "the overload slice (tiered admission)",
    "injector": "the overload slice (fault injection)",
    "preempt": "the overload slice (preemption)",
    "watchdog": "the overload slice (step watchdog)",
    "on_event": "the overload slice (event log)",
}


def percentile(sorted_vals, frac: float):
    """Nearest-rank percentile of an ascending-sorted sequence (the one
    definition the launcher and the benchmarks share)."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("percentile of empty sequence")
    return sorted_vals[max(0, math.ceil(frac * n) - 1)]


@dataclasses.dataclass
class Request:
    """One generation request plus its per-request results and latencies."""

    prompt: np.ndarray  # (S,) prompt tokens
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    # filled in by the engine:
    uid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    status: str = "ok"  # "ok" | "error"
    error: Optional[str] = None  # set when status == "error"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int64).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-completion seconds, or ``None`` before completion."""
        if self.t_done == 0.0 or self.t_submit == 0.0:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        """Submit-to-first-token seconds, or ``None`` before the first token."""
        if self.t_first == 0.0 or self.t_submit == 0.0:
            return None
        return self.t_first - self.t_submit


def _scatter_slots(pool: dict, part: dict, slots: torch.Tensor) -> None:
    """Write micro-batch cache rows into pool rows ``slots``, in place.

    Leaves are (L, rows, ...) with the slot axis 1 (K/V (L, rows, S, KV, hd);
    a mamba layer's conv tails and state (L, rows, ...), written whole, so a
    reused slot keeps nothing of its previous occupant); ``part`` may carry
    MORE rows than ``slots`` (bucketed prefill pads with dummy rows), and
    only the first ``len(slots)`` are written."""
    for name, pl in pool.items():
        pl[:, slots] = part[name][:, : slots.shape[0]]


def _scatter_page_leaf(pl: torch.Tensor, pr: torch.Tensor, bt_rows: torch.Tensor, page: int) -> None:
    """Write micro-batch rows of ONE paged leaf into its page pool, in place.

    pr: the flat prefill leaf (L, G, S, ...), zero-padded by the model to
    max_len; pl: the pool (L, P_phys, page, ...).  Row g's sequence is cut
    into page-sized runs written to the page ids in ``bt_rows[g]``: the
    request's pages, and the trash page for dummy rows and the unallocated
    tail (several runs may land on trash; it is never read).  Every
    allocated page is overwritten whole, so a recycled page never leaks its
    previous occupant's cache."""
    L, G, S = pr.shape[:3]
    n_chunk = -(-S // page)
    if n_chunk * page != S:
        padded = pr.new_zeros((L, G, n_chunk * page) + tuple(pr.shape[3:]))
        padded[:, :, :S] = pr
        pr = padded
    rows = pr.reshape((L, G * n_chunk, page) + tuple(pr.shape[3:]))
    pl[:, bt_rows[:, :n_chunk].reshape(-1).long()] = rows


def _scatter_mixed(pool: dict, part: dict, paged_mask: dict, slots: torch.Tensor, bt_rows: torch.Tensor,
                   page: int) -> None:
    """Leaf-wise prefill scatter of a paged cache: page-pool leaves through
    their block-table rows, slot-resident leaves through the row scatter."""
    for name, pl in pool.items():
        if paged_mask[name]:
            _scatter_page_leaf(pl, part[name], bt_rows, page)
        else:
            _scatter_slots({name: pl}, {name: part[name]}, slots)


def _next_pow2(n: int, floor: int) -> int:
    v = max(floor, 1)
    while v < n:
        v *= 2
    return v


class Engine:
    """Continuous-batching engine binding (model, params) to a KV pool.

    ``decode_block``: decode tokens per host round-trip (1 recovers the
    token-at-a-time loop).  ``page_size`` switches the pool to PAGED mode:
    ``kv_pages`` pages (default: flat-equivalent capacity,
    ``n_slots * ceil(max_len / page_size)``) plus one trash page, admission
    gated on each request's whole footprint ``ceil((prompt + max_new) /
    page_size)`` reserved up front.  ``prefill_chunk`` (paged mode) prefills
    prompts longer than the chunk one (1, chunk) piece per step.
    ``cuda_graph``: capture the decode block as a CUDA graph (default: on a
    CUDA device; the CPU runs it eagerly and refuses ``True``).
    """

    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int,
        max_len: int,
        dispatch: Optional[DispatchConfig] = None,
        eos_token: Optional[int] = None,
        decode_block: int = 8,
        page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        cuda_graph: Optional[bool] = None,
        share_prefix: bool = False,
        warm_cache_pages: Optional[int] = None,
        tiers: Optional[Sequence[float]] = None,
        tier_q: int = 0,
        admission=None,
        injector=None,
        preempt: bool = False,
        watchdog=None,
        on_event=None,
    ):
        later = {"share_prefix": share_prefix, "warm_cache_pages": warm_cache_pages,
                 "tiers": tiers not in (None, (1.0,), [1.0]), "tier_q": tier_q, "admission": admission,
                 "injector": injector, "preempt": preempt, "watchdog": watchdog, "on_event": on_event}
        for name, value in later.items():
            if value not in (None, False, 0):
                raise NotImplementedError(f"Engine({name}=...) is not ported yet: it comes with {_LATER[name]}")
        self.model, self.params = model, params
        self.cfg = model.cfg
        self.device = model.device
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_token = eos_token
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        self.decode_block = decode_block
        self._dcfg = dispatch if dispatch is not None else DispatchConfig.from_arch(self.cfg)
        on_card = self.device.type == "cuda"
        if cuda_graph and not on_card:
            raise ValueError(f"cuda_graph=True needs a CUDA device, the model runs on {self.device}")
        self.cuda_graph = on_card if cuda_graph is None else bool(cuda_graph)

        self.paged = page_size is not None
        self.page_size = page_size
        if prefill_chunk is not None:
            if not self.paged:
                raise ValueError("prefill_chunk requires page_size (paged mode)")
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if model.init_cache_paged is None:
                raise ValueError(f"{self.cfg.family} model has no paged cache builder")
            self.max_pages = -(-max_len // page_size)
            self.kv_pages = kv_pages if kv_pages is not None else n_slots * self.max_pages
            self.cache, self._paged_mask = model.init_cache_paged(n_slots, max_len, page_size, self.kv_pages)
            # no paged leaf (mamba2): every request reserves zero pages
            self._has_pages = any(m for sub in self._paged_mask.values() for m in sub.values())
            self._trash = self.kv_pages  # the trash page id (attention.trash_page)
            self._bt = np.full((n_slots, self.max_pages), self._trash, np.int32)
            self.page_pool = PageAllocator(self.kv_pages)
            self.scheduler = Scheduler(SlotAllocator(n_slots), reserve=self._reserve,
                                       release_grant=self._release_grant)
        else:
            self.kv_pages = self.max_pages = 0
            self._paged_mask = None
            self._has_pages = False
            self._bt = np.zeros((n_slots, 0), np.int32)
            self.page_pool = None
            self.scheduler = Scheduler(SlotAllocator(n_slots))
            self.cache = model.init_cache(n_slots, max_len)
        # byte accounting over every cache subtree (layers, shared_attn):
        # paged leaves are banked per PAGE (axis 1 of a stacked (L, P, page,
        # ...) pool), everything else is resident up front
        self._subtrees = [k for k in self.cache if k != "block_table"]
        leaves = [(sub, name, t) for sub in self._subtrees for name, t in self.cache[sub].items()]
        self.kv_bytes_capacity = sum(t.numel() * t.element_size() for _, _, t in leaves)
        self._bytes_per_page = sum(t.numel() * t.element_size() // t.shape[1] for sub, name, t in leaves
                                   if self._paged_mask[sub][name]) if self.paged else 0
        self._bytes_resident = self.kv_bytes_capacity - self._bytes_per_page * (self.kv_pages + 1)
        self._chunking: Dict[int, list] = {}  # slot -> [request, next_start, table row]

        # per-slot host mirrors of the device state (None = slot idle); the
        # host rewrites them only at admission/finish boundaries, between blocks
        self._reqs: List[Optional[Request]] = [None] * n_slots
        self._tokens = np.zeros((n_slots,), np.int64)  # last emitted token
        self._pos = np.zeros((n_slots,), np.int64)  # next write position
        self._active = np.zeros((n_slots,), bool)
        self._emitted = np.zeros((n_slots,), np.int64)  # == len(req.tokens)
        self._max_new = np.zeros((n_slots,), np.int64)
        self._seeds = np.zeros((n_slots,), np.int64)  # low 32 bits of the request seed
        self._topks = np.zeros((n_slots,), np.int64)
        self._temps = np.zeros((n_slots,), np.float32)
        # the device side: one packed state tensor in, one packed result out,
        # at fixed addresses (a captured graph reads and writes exactly these)
        self._host_state = torch.zeros((_BT + self.max_pages, n_slots), dtype=torch.int64)
        self._state = torch.zeros_like(self._host_state, device=self.device)
        self._out = torch.zeros((2 * decode_block + 5, n_slots), dtype=torch.int64, device=self.device)
        self._graphs: Dict[bool, tuple] = {}  # greedy? -> (graph, dispatch calls, {kernel lib: launches})
        self._next_uid = 0
        # perf accounting
        self.steps = 0  # device decode steps executed
        self.host_syncs = 0  # fused-block host round-trips
        self.graph_replays = 0  # fused blocks run by replaying a captured graph
        self.decode_seconds = 0.0  # host wall time in fused blocks, drain included
        self.decoded_tokens = 0  # tokens emitted by decode (prefill's first token excluded)
        self.peak_active = 0  # max concurrently admitted requests
        self.prefill_chunks = 0  # chunked-prefill chunks executed
        # one (rows, padded length, prompt lengths) per prefill micro-batch
        self.prefill_batches: List[tuple] = []
        self.quarantined = 0  # requests ended on non-finite logits

    # ------------------------------------------------------------------ #
    # submission / introspection
    # ------------------------------------------------------------------ #
    def _page_need(self, request) -> int:
        """Pages a request reserves: its WHOLE footprint (prompt plus
        max_new_tokens), so decode never runs out of pages mid-stream; zero
        where no cache leaf is paged."""
        if not self._has_pages:
            return 0
        return -(-(int(request.prompt.size) + request.max_new_tokens) // self.page_size)

    def _reserve(self, request) -> Optional[PageGrant]:
        """All-or-nothing page reservation for one request (Scheduler hook)."""
        pages = self.page_pool.alloc(self._page_need(request))
        return None if pages is None else PageGrant(pages=pages)

    def _release_grant(self, grant: PageGrant) -> None:
        """Free every page the grant holds (Scheduler hook)."""
        if grant.pages:
            self.page_pool.free(grant.pages)

    def submit(self, request: Request) -> Request:
        if request.prompt.size + request.max_new_tokens > self.max_len:
            raise ValueError(f"prompt ({request.prompt.size}) + max_new_tokens ({request.max_new_tokens}) "
                             f"exceeds max_len ({self.max_len})")
        if self.paged and self._page_need(request) > self.kv_pages:
            raise ValueError(f"request needs {self._page_need(request)} pages but the pool holds "
                             f"{self.kv_pages}: it could never be admitted")
        request.uid = self._next_uid
        self._next_uid += 1
        request.t_submit = time.perf_counter()
        self.scheduler.enqueue(request)
        return request

    @property
    def n_active(self) -> int:
        return self.scheduler.allocator.n_active

    @property
    def n_waiting(self) -> int:
        return self.scheduler.n_waiting

    @property
    def has_work(self) -> bool:
        return self.n_active > 0 or self.n_waiting > 0

    @property
    def batch_utilization(self) -> float:
        """Fraction of executed decode-step rows that emitted a real token."""
        return self.decoded_tokens / (self.steps * self.n_slots) if self.steps else 0.0

    @property
    def tokens_per_sync(self) -> float:
        """Decoded tokens per host round-trip."""
        return self.decoded_tokens / self.host_syncs if self.host_syncs else 0.0

    @property
    def pages_in_use(self) -> int:
        return self.page_pool.n_used if self.paged else 0

    @property
    def peak_pages_in_use(self) -> int:
        return self.page_pool.peak_used if self.paged else 0

    @property
    def kv_bytes_in_use(self) -> int:
        """Cache bytes backing admitted work: allocated pages in paged mode;
        the whole pool in flat mode, committed up front.  The transient
        prefill cache of one micro-batch is not counted."""
        if not self.paged:
            return self.kv_bytes_capacity
        return self._bytes_resident + self._bytes_per_page * self.pages_in_use

    @property
    def kv_bytes_peak(self) -> int:
        if not self.paged:
            return self.kv_bytes_capacity
        return self._bytes_resident + self._bytes_per_page * self.peak_pages_in_use

    def reset_counters(self):
        """Re-arm the perf counters (a benchmark's warm-up boundary); peaks
        re-arm to CURRENT usage."""
        self.steps = self.host_syncs = self.graph_replays = self.decoded_tokens = 0
        self.prefill_chunks = self.quarantined = 0
        self.prefill_batches = []
        self.decode_seconds = 0.0
        self.peak_active = self.scheduler.allocator.n_active
        if self.paged:
            self.page_pool.reset_peak()

    # ------------------------------------------------------------------ #
    # admission + prefill
    # ------------------------------------------------------------------ #
    def _admission_groups(self, placed):
        """Split (slot, request) placements into prefill micro-batches: one
        for the attention families, one per prompt length for ssm and hybrid
        (``repro/serving/engine.py::_admission_groups``)."""
        if self.cfg.family not in _EXACT_LEN_FAMILIES:
            return [placed]
        by_len: Dict[int, list] = {}
        for slot, req in placed:
            by_len.setdefault(int(req.prompt.size), []).append((slot, req))
        return list(by_len.values())

    def _prefill_shape(self, n_reqs: int, max_prompt: int):
        """Bucket the micro-batch shape: batch rows up to the next power of
        two (capped at n_slots; dummy rows are discarded by the scatter) and,
        for the attention families, prompt length up to the next power of two
        >= 8 (capped at max_len), the reference's buckets.  An ssm or hybrid
        group keeps its exact length."""
        G = min(_next_pow2(n_reqs, 1), self.n_slots)
        P = max_prompt
        if self.cfg.family not in _EXACT_LEN_FAMILIES:
            P = max(max_prompt, min(_next_pow2(max_prompt, 8), self.max_len))
        return G, P

    def _prefill_group(self, group) -> List[Request]:
        slots = [slot for slot, _ in group]
        reqs = [req for _, req in group]
        lens = np.array([r.prompt.size for r in reqs], np.int64)
        G, P = self._prefill_shape(len(reqs), int(lens.max()))
        self.prefill_batches.append((G, P, tuple(int(n) for n in lens)))
        toks = np.zeros((G, P), np.int64)
        for i, r in enumerate(reqs):
            toks[i, : r.prompt.size] = r.prompt
        last_index = np.zeros((G,), np.int64)
        last_index[: len(reqs)] = lens - 1
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        logits, part = self.model.prefill(self.params, batch, self.max_len,
                                          last_index=torch.from_numpy(last_index).to(dev))
        slot_idx = torch.tensor(slots, dtype=torch.int64, device=dev)
        if self.paged:
            # dummy rows (and each slot's unallocated table tail) scatter to
            # the trash page; allocated pages are overwritten whole
            bt_rows = np.full((G, self.max_pages), self._trash, np.int32)
            bt_rows[: len(slots)] = self._bt[slots]
            bt_dev = torch.from_numpy(bt_rows).to(dev)
            for sub in self._subtrees:
                _scatter_mixed(self.cache[sub], part[sub], self._paged_mask[sub], slot_idx, bt_dev, self.page_size)
        else:
            for sub in self._subtrees:
                _scatter_slots(self.cache[sub], part[sub], slot_idx)
        first = self._sample(logits, reqs + [None] * (G - len(reqs)), [0] * G)
        now = time.perf_counter()
        for i, (slot, req) in enumerate(group):
            self._activate_slot(slot, req, int(lens[i]), int(first[i]), now)
        finished = []
        for slot in slots:
            done = self._maybe_finish(slot)
            if done is not None:
                finished.append(done)
        return finished

    def _activate_slot(self, slot: int, req: Request, pos: int, first_tok: int, now: float):
        """Post-prefill bookkeeping shared by grouped and chunked prefill."""
        self._reqs[slot] = req
        self._pos[slot] = pos
        self._tokens[slot] = first_tok
        self._active[slot] = True
        self._emitted[slot] = 1
        self._max_new[slot] = req.max_new_tokens
        self._seeds[slot] = req.sampling.seed & 0xFFFFFFFF
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        req.t_first = now
        req.tokens.append(first_tok)

    # ------------------------------------------------------------------ #
    # sampling / completion
    # ------------------------------------------------------------------ #
    def _sample(self, logits, reqs, token_indices) -> np.ndarray:
        """One token per logits row for the given requests (the prefill
        boundary; decode samples inside the fused block)."""
        if all(r is None or r.sampling.temperature == 0 for r in reqs):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        B = logits.shape[0]
        temps = np.zeros((B,), np.float32)
        topks = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        for i, req in enumerate(reqs):
            if req is not None:
                temps[i], topks[i], seeds[i] = req.sampling.temperature, req.sampling.top_k, req.sampling.seed
        dev = logits.device
        salts = token_salts(torch.from_numpy(seeds & 0xFFFFFFFF), torch.tensor(token_indices, dtype=torch.int64))
        out = sample_tokens(logits, salts.to(dev), torch.from_numpy(temps).to(dev), torch.from_numpy(topks).to(dev))
        return out.cpu().numpy()

    def _clear_slot(self, slot: int) -> None:
        """Reset one slot's host mirrors and hand it back to the scheduler."""
        self._reqs[slot] = None
        self._pos[slot] = 0
        self._tokens[slot] = 0
        self._active[slot] = False
        self._emitted[slot] = 0
        self._max_new[slot] = 0
        self._seeds[slot] = 0
        self._topks[slot] = 0
        self._temps[slot] = 0.0
        self.scheduler.release(slot)
        if self.paged:
            # Back to all-trash BEFORE the next block: the freed pages may be
            # granted to another slot, and a stale row would let this (now
            # inactive) slot's idempotent re-writes land in pages it no
            # longer owns.
            self._bt[slot] = self._trash

    def _maybe_finish(self, slot: int) -> Optional[Request]:
        req = self._reqs[slot]
        if req is None:
            return None
        hit_eos = self.eos_token is not None and req.tokens and req.tokens[-1] == self.eos_token
        if req.done or hit_eos:
            req.t_done = time.perf_counter()
            self._clear_slot(slot)
            return req
        return None

    def _quarantine_slot(self, slot: int) -> Request:
        """End one request whose decode went non-finite.  The fused block
        froze its row on the step the bad logits appeared, so no garbage
        token was emitted or fed back; the rest of the batch decoded on."""
        req = self._reqs[slot]
        req.t_done = time.perf_counter()
        req.status = "error"
        req.error = "non-finite logits during decode"
        self._clear_slot(slot)
        self.quarantined += 1
        return req

    # ------------------------------------------------------------------ #
    # chunked prefill (paged mode): one chunk per engine step
    # ------------------------------------------------------------------ #
    def _chunk_step(self):
        """Run ONE prefill chunk for the oldest chunking request; returns
        ``(finished, n_real)``.  Chunks have one (1, chunk) shape, the last
        one right-padded; its logits sample the request's first token and
        the slot joins the decode batch at the next block."""
        slot = next(iter(self._chunking))  # dicts keep admission order
        req, start, row = self._chunking[slot]
        C = self.prefill_chunk
        plen = int(req.prompt.size)
        n = min(C, plen - start)
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = req.prompt[start : start + n]
        dev = self.device
        logits, _ = self.model.prefill_chunk(self.params, self.cache, torch.from_numpy(toks).to(dev),
                                             torch.from_numpy(row).to(dev), start, n)
        self.prefill_chunks += 1
        start += n
        if start < plen:
            self._chunking[slot][1] = start
            return [], n
        del self._chunking[slot]
        # the last chunk landed: publish the row, so the decode block (and
        # its page writes) see the slot's pages from here on
        self._bt[slot] = row
        first = self._sample(logits, [req], [0])
        self._activate_slot(slot, req, plen, int(first[0]), time.perf_counter())
        done = self._maybe_finish(slot)
        return ([done] if done is not None else []), n

    # ------------------------------------------------------------------ #
    # the fused decode block
    # ------------------------------------------------------------------ #
    def _block_body(self, greedy: bool) -> None:
        """``decode_block`` decode iterations over the device buffers: decode
        step -> sample -> stop detection -> buffer update, then the packed
        result into ``self._out``.  Reads ``self._state`` and never writes
        it, so running it with every slot frozen changes nothing but K/V
        rows the next real block rewrites with the same values, and the
        frozen slots' recurrent rows (which drift)."""
        st, out, n = self._state, self._out, self.decode_block
        if self.paged:
            self.cache["block_table"].copy_(st[_BT:].T)
        tokens, pos, emitted = st[_TOK], st[_POS], st[_EMIT]
        active = st[_ACT] != 0
        max_new, seeds, topks = st[_MAXNEW], st[_SEED], st[_TOPK]
        temps = st[_TEMP].to(torch.int32).view(torch.float32)
        eos = _NO_EOS if self.eos_token is None else int(self.eos_token)
        quar = torch.zeros_like(active)
        for i in range(n):
            logits, _ = self.model.decode_step(self.params, self.cache, tokens[:, None], pos)
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                # salt from the CURRENT emitted count, the token's index in its stream
                nxt = sample_tokens(logits, token_salts(seeds, emitted), temps, topks)
            # a slot whose logits went non-finite freezes THIS step: the
            # garbage token is never emitted or fed back
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            quar = quar | bad
            emit = active & ~bad
            # frozen slots re-feed their last token at their frozen position
            nxt = torch.where(emit, nxt, tokens)
            step = emit.long()
            pos = pos + step
            emitted = emitted + step
            active = emit & (emitted < max_new) & (nxt != eos)
            tokens = nxt
            out[i].copy_(nxt)
            out[n + i].copy_(step)
        out[2 * n].copy_(tokens)
        out[2 * n + 1].copy_(pos)
        out[2 * n + 2].copy_(active.long())
        out[2 * n + 3].copy_(emitted)
        out[2 * n + 4].copy_(quar.long())

    def _graph(self, greedy: bool):
        """The captured decode block for one sampling variant, built on first use.

        ``self._state`` already holds this block's inputs.  One eager
        warm-up pass of the block runs with every slot frozen, on the side
        stream that then captures it: the body has no data-dependent host
        control flow, so that pass runs every op the capture records, and
        every first use that may not happen inside a capture (loading a
        kernel library, a cuBLAS handle and its workspace for that stream,
        a launch plan's cached device query) happens there first.  A capture
        on any other stream (``torch.cuda.graph``'s own, by default) would
        meet cuBLAS's first use of that stream inside the capture, which
        invalidates it.  Frozen slots still advance their recurrent rows
        (mamba conv tails and states), which would corrupt the live slots'
        states, so the cache is saved before the warm-up and restored after
        it.  Launches and dispatch calls made during capture are recorded
        per graph and counted per replay.  Python's cyclic garbage collector
        is off during the capture: a dead engine's graph freed inside it
        (its destructor destroys a graph exec, which a capture does not
        permit) would invalidate the capture."""
        entry = self._graphs.get(greedy)
        if entry is not None:
            return entry
        saved = [(t, t.clone()) for sub in self._subtrees for t in self.cache[sub].values()]
        active = self._state[_ACT].clone()
        self._state[_ACT].zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._block_body(greedy)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, copy in saved:
            t.copy_(copy)
        del saved
        self._state[_ACT].copy_(active)
        libs = kernel_libs()
        before = [lib.captured for lib in libs]
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with dispatch.recording_capture() as calls, torch.cuda.graph(graph, stream=side):
                self._block_body(greedy)
        finally:
            if gc_on:
                gc.enable()
        launches = {lib: lib.captured - b for lib, b in zip(libs, before) if lib.captured > b}
        entry = (graph, Counter(calls), launches)
        self._graphs[greedy] = entry
        return entry

    def _fused_pass(self, mask: np.ndarray) -> List[Request]:
        """Run one fused decode block over the slots in ``mask``."""
        t0 = time.perf_counter()
        greedy = not bool((self._temps[mask] > 0).any())
        hs = self._host_state.numpy()
        hs[_TOK], hs[_POS], hs[_ACT], hs[_EMIT] = self._tokens, self._pos, mask, self._emitted
        hs[_MAXNEW], hs[_SEED], hs[_TOPK] = self._max_new, self._seeds, self._topks
        hs[_TEMP] = self._temps.view(np.int32)
        hs[_BT:] = self._bt.T
        self._state.copy_(self._host_state)  # THE copy in
        if self.cuda_graph:
            graph, calls, launches = self._graph(greedy)
            graph.replay()
            self.graph_replays += 1
            dispatch.add_replays(calls)
            for lib, n in launches.items():
                lib.replayed(n)
        else:
            self._block_body(greedy)
        res = self._out.cpu().numpy()  # THE host sync: the whole packed result at once
        n = self.decode_block
        toks, emits = res[:n], res[n : 2 * n].astype(bool)
        quar = res[2 * n + 4].astype(bool)
        self._tokens[mask] = res[2 * n][mask]
        self._pos[mask] = res[2 * n + 1][mask]
        self._active[mask] = res[2 * n + 2][mask].astype(bool)
        self._emitted[mask] = res[2 * n + 3][mask]
        self.steps += n
        self.host_syncs += 1
        self.decoded_tokens += int(emits.sum())

        finished: List[Request] = []
        for s in np.nonzero(emits.any(axis=0) | quar)[0]:
            s = int(s)
            req = self._reqs[s]
            req.tokens.extend(int(t) for t, e in zip(toks[:, s], emits[:, s]) if e)
            if quar[s]:
                finished.append(self._quarantine_slot(s))
                continue
            done = self._maybe_finish(s)
            if done is not None:
                finished.append(done)
        self.decode_seconds += time.perf_counter() - t0
        return finished

    # ------------------------------------------------------------------ #
    # the engine step
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit waiting requests (paged mode: gated on free PAGES, long
        prompts to the chunked-prefill queue), run up to ~one chunk's worth
        of prefill chunks, then one fused decode block; returns the requests
        that finished during this step."""
        with use_dispatch(self._dcfg):
            return self._step()

    def _step(self) -> List[Request]:
        finished: List[Request] = []
        placed = self.scheduler.admit()
        if placed:
            self.peak_active = max(self.peak_active, self.scheduler.allocator.n_active)
        chunking = self.paged and self.prefill_chunk is not None and self.model.prefill_chunk is not None
        direct = []
        for slot, req in placed:
            row = None
            if self.paged:
                grant = self.scheduler.slot_pages[slot]
                row = np.full((self.max_pages,), self._trash, np.int32)
                row[: len(grant.pages)] = grant.pages
            if chunking and req.prompt.size > self.prefill_chunk:
                # The slot's DEVICE table row stays on trash until the last
                # chunk lands: the decode block's frozen-slot re-feeds write
                # through the table at position 0, and a published row would
                # let them corrupt the half-prefilled pages.  The chunk gets
                # the real row as an explicit argument instead.
                self._chunking[slot] = [req, 0, row]
            else:
                if row is not None:
                    self._bt[slot] = row
                direct.append((slot, req))
        for group in self._admission_groups(direct) if direct else ():
            # requests whose single token came from prefill finish here
            finished.extend(self._prefill_group(group))
        if self._chunking:
            # a prefill budget of ~one chunk of REAL tokens per step, so a
            # long prefill never stalls the running decodes for long
            budget = self.prefill_chunk
            while self._chunking and budget > 0:
                done, n_real = self._chunk_step()
                finished.extend(done)
                budget -= max(n_real, 1)
        if self._active.any():
            finished.extend(self._fused_pass(self._active.copy()))
        return finished

    def run(self, requests: Sequence[Request], arrivals: Optional[Sequence[float]] = None, *,
            max_idle_wait: float = 0.05) -> List[Request]:
        """Submit ``requests`` (optionally at wall-clock ``arrivals`` offsets,
        seconds) and step until all complete; returns them in finish order.
        Idle until the next arrival in naps of at most ``max_idle_wait``."""
        order = sorted(range(len(requests)), key=lambda i: arrivals[i] if arrivals else 0)
        t0 = time.perf_counter()
        pending = list(order)
        finished: List[Request] = []
        while pending or self.has_work:
            now = time.perf_counter() - t0
            while pending and (arrivals is None or arrivals[pending[0]] <= now):
                self.submit(requests[pending[0]])
                pending.pop(0)
            if self.has_work:
                finished.extend(self.step())
                continue
            if pending:
                wait = arrivals[pending[0]] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(min(wait, max_idle_wait))
        return finished
