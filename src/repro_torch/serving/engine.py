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
    recurrent state.  A sliding-window arch (h2o-danube) pads up to its
    window W at most, and groups by exact length once a prompt exceeds W;
    its O(W) ring is a slot row, never paged, so it reserves zero pages;
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

Prefix sharing (``share_prefix=True``, paged mode, the dense and moe
families): admission matches a new prompt's leading FULL pages against a
:class:`PrefixIndex` of pages whose K/V has landed, live or cached
(released, refcount 0, contents intact on the free list).  Matched pages
are mapped read-only into the slot's block table (one allocator reference
each); only the tail is allocated and prefilled, entering the model
mid-prompt through the chunk program.  When the whole prompt is covered,
the last prompt token re-runs at ``start = L - 1`` after its page is
COW-forked (``attention.copy_page``) onto a private page.  Finished
requests register their decode-filled pages too (the session cache), after
rewriting them through the chunk program, so a follow-up turn that extends
(prompt + reply) matches past its first prompt.  The COW copy, the
rewrites and the prompt chunks all run on the engine's current stream,
where the captured decode block replays, and a block-table row reaches the
device state only after its last chunk has landed.  Sharing relocates
bytes and never changes what is attended: with every prompt longer than
one chunk, shared and unshared engines compute every position through one
program at one shape, and emit the same greedy tokens bit for bit.

Rank tiers (``tiers``, the reference's elastic ranks): tier 0 serves the
stored factors, tier t their prefix views ``slice_rank(params, tiers[t])``
(no parameter memory), each with a Theorem 3.2 certificate of the head's
dropped tail (``tier_certificates``, ``Request.certificate``).  Prefill
micro-batches split by tier; decode runs one fused block per active tier,
the other tiers' slots riding along frozen (their re-feeds write their
frozen position with this tier's params, which their own next block
rewrites before anything reads it; recurrent state would not repair, so
the ssm and hybrid families take one tier only).  Each tier keeps its own
prefix index: a page's bytes depend on the params that wrote them.  On the
card each (tier, sampling variant) is captured once.

Overload and faults: an :class:`AdmissionPolicy` sheds deadline-expired
waiters (``status="shed"`` with a :class:`RejectedOverload`) and degrades
admissions to a cheaper tier under queue or page pressure; ``preempt``
lets a higher-priority waiter evict the cheapest running request, whose
continuation (prompt + tokens so far) re-queues right behind it and, with
``share_prefix``, matches its own rematerialized pages; a
:class:`FaultInjector` denies page reservations, slows steps and poisons a
request's logits with NaN (the poison is a row of the packed device state,
so one captured block serves armed and unarmed runs, and the poisoned
slot takes the quarantine path); a :class:`StepWatchdog` flags slow
steps; ``on_event(kind, fields)`` receives shed, degrade, preempt,
quarantine and straggler events.  ``run(stop=...)`` drains gracefully: the
queue sheds with ``"shutdown"``, in-flight requests finish;
``export_inflight`` evicts every in-flight request as a continuation that
another engine resumes.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bounds import CompressionCertificate, certify_tier
from repro_torch.core.lowrank import is_lowrank, slice_rank
from repro_torch.kernels._build import kernel_libs
from repro_torch.runtime import dispatch
from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
from repro_torch.runtime.fault_tolerance import FaultInjector, StepWatchdog
from repro_torch.serving.sampling import SamplingParams, sample_tokens, token_salts
from repro_torch.serving.scheduler import (AdmissionPolicy, PageAllocator, PageGrant, PrefixIndex, RejectedOverload,
                                           Scheduler, SlotAllocator)

__all__ = ["Request", "Engine", "SamplingParams", "AdmissionPolicy", "RejectedOverload", "FaultInjector",
           "StepWatchdog", "percentile"]

# eos sentinel for the fused stop check when no eos token is configured:
# sampled token ids are always >= 0, so -1 never matches.
_NO_EOS = -1

# rows of the packed per-slot state (one int64 (rows, n_slots) tensor); the
# paged engine's block table follows, transposed, in rows _BT onwards.
# _POISON: the step within the block at which a slot's logits turn NaN
# (the fault injector's), -1 for none
_TOK, _POS, _ACT, _EMIT, _MAXNEW, _SEED, _TOPK, _TEMP, _POISON, _BT = range(10)

# One capture at a time in the process, and no engine's graphs released during
# one: several engines may share a process, each stepped by its own thread (the
# serving cluster's replicas).  A capture counts the launches recorded while it
# runs (``KernelLib.captured``), turns Python's cyclic collector off (a
# process-wide switch) and must not see a graph exec destroyed by another
# thread; holding this lock around every capture and every release keeps all
# three to the one capture that runs.
GRAPH_LOCK = threading.Lock()

# Families whose decode state integrates every prefill token (recurrent and
# convolutional state): right-padding would corrupt it, so their admission
# micro-batches group by EXACT prompt length (repro/serving/engine.py:122-125).
_EXACT_LEN_FAMILIES = ("ssm", "hybrid")


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
    # per-request model inputs besides the prompt, unbatched: a vlm's
    # "image_embed" (n_image_tokens, d_model), an audio model's "frames"
    # (n_audio_frames, d_model) (``data.synthetic.modality_extras``)
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # the overload contract (the defaults are plain FIFO):
    deadline_ms: Optional[float] = None  # shed if not admitted within this
    min_tier: int = 0  # deepest rank tier the client accepts under pressure
    tier: int = 0  # tier served (admission may raise it, never lower it)
    priority: int = 0  # a higher-priority waiter may preempt a lower active
    # filled in by the engine:
    uid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    prefill_skipped: int = 0  # prompt tokens covered by shared prefix pages
    status: str = "ok"  # "ok" | "shed" | "error"
    rejected: Optional[RejectedOverload] = None  # set when status == "shed"
    error: Optional[str] = None  # set when status == "error"
    certificate: Optional[CompressionCertificate] = None  # the served tier's bound
    # a preempted request's continuation points at the original request,
    # whose token stream it extends (never set by callers)
    _parent: Optional["Request"] = dataclasses.field(default=None, repr=False)

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
    ``share_prefix`` (paged mode) maps repeated prompt-prefix pages
    read-only instead of prefilling them again; inert for the ssm and hybrid
    families, whose prefill cannot enter mid-prompt.  ``warm_cache_pages``
    caps how many released pages stay matchable (None: until a writer needs
    them).  ``cuda_graph``: capture the decode block as a CUDA graph (default: on a
    CUDA device; the CPU runs it eagerly and refuses ``True``).

    ``tiers``: rank fractions, strictly decreasing from 1.0 (tier 0); a
    request's ``tier`` picks one, and ``tier_q`` is recorded in the tiers'
    certificates.  ``admission``: an :class:`AdmissionPolicy` (deadline
    shedding, degradation under pressure).  ``injector``: a
    :class:`FaultInjector`.  ``preempt``: a waiter of higher priority may
    evict the cheapest active request.  ``watchdog``: a
    :class:`StepWatchdog` timing every ``step()``.  ``on_event(kind,
    fields)``: the sink of overload events.
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

        # rank tiers: nested prefix views of the stored factors
        tiers = tuple(float(f) for f in tiers) if tiers else (1.0,)
        if tiers[0] != 1.0:
            raise ValueError(f"tiers[0] must be 1.0 (the serving rank), got {tiers}")
        if any(not 0.0 < f <= 1.0 for f in tiers) or any(a <= b for a, b in zip(tiers, tiers[1:])):
            raise ValueError(f"tiers must be strictly decreasing in (0, 1]: {tiers}")
        if len(tiers) > 1 and self.cfg.family in _EXACT_LEN_FAMILIES:
            # a frozen slot's re-feeds integrate into its recurrent state with
            # another tier's params during that tier's block, and never repair
            raise ValueError(f"multi-tier serving is not supported for the {self.cfg.family} family "
                             "(recurrent decode state)")
        self.tiers = tiers
        self._tier_params = [params] + [slice_rank(params, f) for f in tiers[1:]]
        self.tier_certificates = self._build_tier_certificates(tier_q)
        self.admission = admission
        self.injector = injector
        self.preempt = preempt
        self.watchdog = watchdog
        self.on_event = on_event

        self.paged = page_size is not None
        self.page_size = page_size
        if prefill_chunk is not None:
            if not self.paged:
                raise ValueError("prefill_chunk requires page_size (paged mode)")
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        if share_prefix and not self.paged:
            raise ValueError("share_prefix requires page_size (paged mode)")
        if warm_cache_pages is not None and not self.paged:
            raise ValueError("warm_cache_pages requires page_size (paged mode)")
        self.share_prefix = share_prefix
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
            # sharing needs something paged to share and a mid-prompt entry
            # (the chunk program); otherwise the flag is inert, not an error
            self._share = share_prefix and self._has_pages and model.prefill_chunk is not None
            # one index per tier: a page's bytes depend on the params that wrote them
            self._prefix = [PrefixIndex(page_size) for _ in tiers] if self._share else None
            # one chunk shape for long prompts, shared tails and rewrites alike
            self._chunk_C = prefill_chunk if prefill_chunk is not None else (page_size if self._share else None)
            # the allocator owns the warm cache's lifetime: its on_evict is the
            # only place index keys die outside an explicit reset
            self.page_pool = PageAllocator(self.kv_pages, cache_budget=warm_cache_pages, on_evict=self._on_evict)
            self.scheduler = Scheduler(SlotAllocator(n_slots), reserve=self._reserve,
                                       release_grant=self._release_grant, policy=admission,
                                       pressure=self._free_page_frac)
        else:
            self.kv_pages = self.max_pages = 0
            self._paged_mask = None
            self._has_pages = False
            self._bt = np.zeros((n_slots, 0), np.int32)
            self._share, self._prefix, self._chunk_C = False, None, None
            self.page_pool = None
            self.scheduler = Scheduler(SlotAllocator(n_slots), policy=admission)
            self.cache = model.init_cache(n_slots, max_len)
        self.scheduler.on_event = on_event
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
        # (tier, greedy?) -> (graph, dispatch calls, {kernel lib: launches})
        self._graphs: Dict[tuple, tuple] = {}
        self._next_uid = 0
        # perf accounting
        self.steps = 0  # device decode steps executed
        self.host_syncs = 0  # fused-block host round-trips
        self.graph_replays = 0  # fused blocks run by replaying a captured graph
        self.capture_seconds = 0.0  # host time building captured blocks (cumulative: reset_counters keeps it)
        self.decode_seconds = 0.0  # host wall time in fused blocks, drain included
        self.decoded_tokens = 0  # tokens emitted by decode (prefill's first token excluded)
        self.peak_active = 0  # max concurrently admitted requests
        self.prefill_chunks = 0  # chunked-prefill chunks executed
        # one (rows, padded length, prompt lengths) per prefill micro-batch
        self.prefill_batches: List[tuple] = []
        self.quarantined = 0  # requests ended on non-finite logits
        # prefix sharing: pages mapped instead of allocated and prefilled,
        # admissions that matched, COW forks, and the prompt tokens skipped
        self.shared_page_hits = self.shared_admissions = self.cow_forks = 0
        self.skipped_prefill_tokens = 0
        self.preemptions = 0  # slots preempted for higher-priority waiters
        self.straggler_flags = 0  # steps the watchdog flagged
        self.exported = 0  # in-flight requests evicted by export_inflight
        self._step_idx = 0  # step() calls (the injector's clock)

    def _free_page_frac(self) -> float:
        """Free pages over the pool, in [0, 1]: the admission policy's
        pressure signal (1.0 where no page pressure exists)."""
        if not self.paged or self.kv_pages == 0:
            return 1.0
        return self.page_pool.n_free / self.kv_pages

    def _build_tier_certificates(self, tier_q: int) -> list:
        """One Theorem 3.2 certificate per tier, of the deviation the tier adds
        over the stored rank: the spectral norm of the factor tail its slice
        drops, on the compressed head (the factor pair projecting to the
        vocabulary) or else the largest factor pair as a proxy.  A checkpoint
        with nothing factored certifies zero (``repro/serving/engine.py::
        _build_tier_certificates``)."""
        if len(self.tiers) == 1:
            return [None]
        head = None

        def walk(node):
            nonlocal head
            if is_lowrank(node):
                a, b = node["a"], node["b"]
                if b.dim() == 2 and b.shape[-1] == self.cfg.vocab:
                    head = (a, b, True)
                elif head is None or (not head[2] and a.numel() > head[0].numel()):
                    head = (a, b, False)
                return
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)

        walk(self.params)
        certs = []
        for f in self.tiers:
            if head is None:
                certs.append(CompressionCertificate(0.0, 1.0, 0.0, rank=0, q=tier_q))
                continue
            a, b, _ = head
            r = a.shape[-1]
            gen = torch.Generator(device=a.device).manual_seed(0)
            certs.append(certify_tier(a, b, max(1, min(r, int(math.ceil(f * r)))), gen, q=tier_q))
        return certs

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
        """All-or-nothing page reservation for one request (Scheduler hook).

        Matches the prompt's leading full pages in the prefix index, takes
        one reference on each (reviving cached ones) and allocates only the
        rest.  A fully covered prompt re-enters at ``L - 1`` with its last
        matched page COW-forked onto a fresh page; where the pool cannot fit
        that extra page, the boundary page is un-shared instead (retrying the
        same transaction on a full pool could never succeed).  On failure
        every reference is given back and the peak restored, so admission
        stays atomic and strictly FIFO
        (``repro/serving/engine.py::_reserve``).  An armed injector's
        ``deny_pages`` window fails it outright."""
        if self.injector is not None and self.injector.deny_reserve(self._step_idx):
            return None
        need = self._page_need(request)
        L = int(request.prompt.size)
        peak0 = self.page_pool.peak_used
        acquired: List[int] = []
        if self._share and L >= 2:  # L >= 2 keeps the mid-prompt entry at start >= 1
            for p in self._prefix[request.tier].match(request.prompt):
                if len(acquired) >= need or not self.page_pool.acquire(p):
                    break
                acquired.append(p)
        k = len(acquired)
        start = k * self.page_size
        if k and start == L:
            start = L - 1  # the last prompt token still runs: its logits seed sampling
        fork = bool(k) and start // self.page_size < k
        fresh = self.page_pool.alloc(need - k + (1 if fork else 0))
        if fresh is None and fork:
            self.page_pool.free([acquired.pop()])
            k -= 1
            start, fork = k * self.page_size, False
            fresh = self.page_pool.alloc(need - k)
        if fresh is None:
            if acquired:
                self.page_pool.free(acquired)
            self.page_pool.rollback_peak(peak0)
            return None
        if fork:
            grant = PageGrant(pages=acquired[:-1] + fresh, n_shared=k - 1, start=start,
                              cow=(acquired[-1], fresh[0]), refs=acquired + fresh)  # the source pinned
        else:
            grant = PageGrant(pages=acquired + fresh, n_shared=k, start=start)
        if k:
            self.shared_admissions += 1
            self.shared_page_hits += grant.n_shared
            self.skipped_prefill_tokens += grant.start
            request.prefill_skipped = grant.start
            self.page_pool.record_saved(acquired[: grant.n_shared])  # only a grant that sticks
        return grant

    def _on_evict(self, pages: List[int]) -> None:
        """The allocator's eviction callback: a cached page goes to a writer
        (or the budget sweeps it), so its index keys die with it."""
        if self._prefix is not None:
            for index in self._prefix:
                index.drop_pages(pages)

    def _release_grant(self, grant: PageGrant) -> None:
        """Drop one reference on every page the grant holds (Scheduler hook);
        an indexed page whose last reader leaves becomes a warm-cache entry."""
        if grant.refs:
            self.page_pool.free(grant.refs)

    def reset_prefix_cache(self) -> None:
        """Forget every prefix-index entry (a benchmark's warm-up boundary);
        live slots keep their shared pages, and no eviction is counted."""
        if self._prefix is not None:
            for index in self._prefix:
                index.clear()
            self.page_pool.flush_cache()

    def drop_session(self, prompt) -> int:
        """Close a conversation branch now: drop the prompt's chain and every
        registered extension from every tier's index, and release their
        cached pages for clean reuse.  Returns the cached pages freed."""
        if self._prefix is None:
            return 0
        prompt = np.asarray(prompt).reshape(-1)
        return sum(self.page_pool.drop_cached(index.drop_branch(prompt)) for index in self._prefix)

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
    def prefix_evictions(self) -> int:
        """Warm-cache pages evicted (a writer's grant or the budget's sweep)."""
        return self.page_pool.evictions if self.paged else 0

    @property
    def prefix_cached_pages(self) -> int:
        """Released pages still matchable in the prefix index."""
        return self.page_pool.n_cached if self.paged else 0

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
        self.prefill_chunks = self.quarantined = self.preemptions = self.straggler_flags = self.exported = 0
        self.shared_page_hits = self.shared_admissions = self.cow_forks = 0
        self.skipped_prefill_tokens = 0
        self.prefill_batches = []
        self.decode_seconds = 0.0
        self.peak_active = self.scheduler.allocator.n_active
        if self.paged:
            self.page_pool.reset_peak()
            self.page_pool.evictions = 0

    # ------------------------------------------------------------------ #
    # admission + prefill
    # ------------------------------------------------------------------ #
    def _admission_groups(self, placed):
        """Split (slot, request) placements into prefill micro-batches: by
        tier first (one params tree a call), then one group for the
        attention families and one per prompt length for ssm and hybrid
        (``repro/serving/engine.py::_admission_groups``).  A sliding-window
        tier whose longest prompt exceeds the window also groups by exact
        length: the ring keeps the last W positions of the PADDED prompt, so
        a shorter prompt in the pad would land in the wrong slots."""
        by_tier: Dict[int, list] = {}
        for slot, req in placed:
            by_tier.setdefault(req.tier, []).append((slot, req))
        groups = []
        W = self.cfg.sliding_window
        for tier in sorted(by_tier):
            exact = self.cfg.family in _EXACT_LEN_FAMILIES or (
                W is not None and max(int(req.prompt.size) for _, req in by_tier[tier]) > W)
            if not exact:
                groups.append(by_tier[tier])
                continue
            by_len: Dict[int, list] = {}
            for slot, req in by_tier[tier]:
                by_len.setdefault(int(req.prompt.size), []).append((slot, req))
            groups.extend(by_len.values())
        return groups

    def _prefill_shape(self, n_reqs: int, max_prompt: int):
        """Bucket the micro-batch shape: batch rows up to the next power of
        two (capped at n_slots; dummy rows are discarded by the scatter) and,
        for the attention families, prompt length up to the next power of two
        >= 8 (capped at max_len, and at the sliding window, past which the
        ring forbids padding), the reference's buckets.  An ssm or hybrid
        group keeps its exact length."""
        G = min(_next_pow2(n_reqs, 1), self.n_slots)
        P = max_prompt
        if self.cfg.family not in _EXACT_LEN_FAMILIES:
            cap = self.max_len
            if self.cfg.sliding_window is not None:
                cap = min(cap, self.cfg.sliding_window)
            P = max(max_prompt, min(_next_pow2(max_prompt, 8), cap))
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
        for name in reqs[0].extras:  # stacked over the group, dummy rows zero
            rows = [np.asarray(r.extras[name], np.float32) for r in reqs]
            rows += [np.zeros_like(rows[0])] * (G - len(reqs))
            batch[name] = torch.from_numpy(np.stack(rows)).to(dev)
        tier = reqs[0].tier  # _admission_groups splits by tier
        logits, part = self.model.prefill(self._tier_params[tier], batch, self.max_len,
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
            if self._share:
                # registered only now that the pages' K/V is written (on this
                # stream): same-round admissions just miss the chance once
                for slot, req in group:
                    self.page_pool.mark_indexed(self._prefix[tier].register(req.prompt, self._bt[slot]))
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
        req.certificate = self.tier_certificates[req.tier]
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
            if self._share:
                self._register_session(slot, req)
            self._clear_slot(slot)
            return self._finalize(req)
        return None

    def _finalize(self, req: Request) -> Request:
        """Fold a finished continuation back into the original request, whose
        object the client holds: its tokens extend the stream and its end
        state carries over.  Any other request passes through."""
        root = req._parent
        if root is None:
            return req
        root.tokens.extend(req.tokens)
        root.t_done = req.t_done
        root.status = req.status
        root.error = req.error
        return root

    def _register_session(self, slot: int, req: Request) -> None:
        """Register the finished slot's DECODE-FILLED full pages (the session
        cache), before release, so that ``free`` caches them: a follow-up
        turn extending (prompt + reply) matches them and prefills only its
        new suffix.  The sequence stops one token short of the reply: the
        last token's K/V is written only by frozen re-feeds.  The generated
        span is first rewritten through the chunk program (decode and
        prefill round differently), so indexed pages hold the bytes a cold
        prefill of the same tokens writes."""
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int64)])
        full_end = (seq.size // self.page_size) * self.page_size
        if full_end > req.prompt.size:
            self._rematerialize(slot, seq, int(req.prompt.size), full_end, req.tier)
        self.page_pool.mark_indexed(self._prefix[req.tier].register(seq, self._bt[slot]))

    def _quarantine_slot(self, slot: int) -> Request:
        """End one request whose decode went non-finite.  The fused block
        froze its row on the step the bad logits appeared, so no garbage
        token was emitted or fed back; the rest of the batch decoded on.
        Its pages are never indexed (possibly poisoned K/V must not back a
        match): they free for clean reuse."""
        req = self._reqs[slot]
        req.t_done = time.perf_counter()
        req.status = "error"
        req.error = "non-finite logits during decode"
        self._clear_slot(slot)
        self.quarantined += 1
        if self.on_event is not None:
            self.on_event("quarantine", {"uid": req.uid, "emitted": len(req.tokens), "slot": slot})
        return self._finalize(req)

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
        plen = int(req.prompt.size)
        logits, n = self._run_chunk(req.prompt, row, start, plen, req.tier)
        start += n
        if start < plen:
            self._chunking[slot][1] = start
            return [], n
        del self._chunking[slot]
        # the last chunk landed: publish the row, so the decode block (and
        # its page writes) see the slot's pages from here on
        self._bt[slot] = row
        if self._share:  # the prompt's full pages are written: offer them
            self.page_pool.mark_indexed(self._prefix[req.tier].register(req.prompt, row))
        first = self._sample(logits, [req], [0])
        self._activate_slot(slot, req, plen, int(first[0]), time.perf_counter())
        done = self._maybe_finish(slot)
        return ([done] if done is not None else []), n

    def _run_chunk(self, seq: np.ndarray, row: np.ndarray, start: int, end: int, tier: int):
        """One (1, C) chunk of ``seq[start:end]`` (at most C real tokens,
        right-padded) through the chunk program, with tier ``tier``'s params,
        into the pages of ``row``; returns (logits at its last real token,
        tokens run)."""
        C = self._chunk_C
        n = min(C, end - start)
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = seq[start : start + n]
        dev = self.device
        logits, _ = self.model.prefill_chunk(self._tier_params[tier], self.cache, torch.from_numpy(toks).to(dev),
                                             torch.from_numpy(row).to(dev), start, n)
        self.prefill_chunks += 1
        return logits, n

    def _rematerialize(self, slot: int, seq: np.ndarray, start: int, end: int, tier: int) -> None:
        """Rewrite positions ``[start, end)`` of the slot's pages through the
        chunk program, the logits discarded: decode wrote them with the
        single-query path, whose sums round differently, and indexed pages
        must hold what a cold prefill writes
        (``repro/serving/engine.py::_rematerialize``)."""
        row = self._bt[slot]
        while start < end:
            start += self._run_chunk(seq, row, start, end, tier)[1]

    def _cow_fork(self, src: int, dst: int) -> None:
        """Copy physical page ``src`` onto ``dst`` in every paged leaf of every
        cache subtree, before the forked slot writes its last prompt token
        into ``dst``; ``src`` stays pinned by the grant until release."""
        from repro_torch.models.attention import copy_page

        for sub in self._subtrees:
            for name, pool in self.cache[sub].items():
                if self._paged_mask[sub][name]:
                    copy_page(pool, src, dst, axis=1)  # stacked (L, P, page, ...) pools
        self.cow_forks += 1

    # ------------------------------------------------------------------ #
    # the fused decode block
    # ------------------------------------------------------------------ #
    def _block_body(self, tier: int, greedy: bool) -> None:
        """``decode_block`` decode iterations over the device buffers, with
        tier ``tier``'s params: decode step -> sample -> stop detection ->
        buffer update, then the packed result into ``self._out``.  Reads
        ``self._state`` and never writes it, so running it with every slot
        frozen changes nothing but K/V rows the next real block rewrites
        with the same values, and the frozen slots' recurrent rows (which
        drift).  With an injector the state's poison row turns a slot's
        logits NaN at one step (device data: the same ops armed or not)."""
        st, out, n = self._state, self._out, self.decode_block
        params = self._tier_params[tier]
        if self.paged:
            self.cache["block_table"].copy_(st[_BT:].T)
        tokens, pos, emitted = st[_TOK], st[_POS], st[_EMIT]
        active = st[_ACT] != 0
        max_new, seeds, topks = st[_MAXNEW], st[_SEED], st[_TOPK]
        temps = st[_TEMP].to(torch.int32).view(torch.float32)
        eos = _NO_EOS if self.eos_token is None else int(self.eos_token)
        quar = torch.zeros_like(active)
        poison = st[_POISON] if self.injector is not None else None
        for i in range(n):
            logits, _ = self.model.decode_step(params, self.cache, tokens[:, None], pos)
            if poison is not None:
                logits = torch.where((poison == i)[:, None], torch.full_like(logits[:1, :1], math.nan), logits)
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

    def _graph(self, tier: int, greedy: bool):
        """The captured decode block of one tier and sampling variant, built
        on first use.

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
        permit) would invalidate the capture.  The capture holds
        :data:`GRAPH_LOCK` and runs in ``thread_local`` capture mode: another
        thread's engine may sync, allocate or launch on its own stream
        meanwhile (the default ``global`` mode would make those calls fail),
        but no other capture or graph release runs beside it.
        ``capture_seconds`` adds up the host time of the warm-ups and
        captures."""
        entry = self._graphs.get((tier, greedy))
        if entry is not None:
            return entry
        t0 = time.perf_counter()
        with GRAPH_LOCK:
            entry = self._capture(tier, greedy)
        self._graphs[(tier, greedy)] = entry
        self.capture_seconds += time.perf_counter() - t0
        return entry

    def _capture(self, tier: int, greedy: bool):
        """The warm-up pass and the capture of :meth:`_graph` (lock held)."""
        saved = [(t, t.clone()) for sub in self._subtrees for t in self.cache[sub].values()]
        active = self._state[_ACT].clone()
        self._state[_ACT].zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._block_body(tier, greedy)
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
            with (dispatch.recording_capture() as calls,
                  torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local")):
                self._block_body(tier, greedy)
        finally:
            if gc_on:
                gc.enable()
        launches = {lib: lib.captured - b for lib, b in zip(libs, before) if lib.captured > b}
        return graph, Counter(calls), launches

    def close(self) -> None:
        """Release the captured decode blocks, under :data:`GRAPH_LOCK`: a
        graph exec destroyed while another thread captures would invalidate
        that capture.  The engine captures anew if it steps again."""
        with GRAPH_LOCK:
            graphs, self._graphs = self._graphs, {}
            graphs.clear()

    def _fused_pass(self, tier: int, mask: np.ndarray, poison: tuple) -> List[Request]:
        """Run one fused decode block over the slots in ``mask`` (one tier);
        ``poison``: the injector's (slot, step within the block), or (-1, -1)."""
        t0 = time.perf_counter()
        greedy = not bool((self._temps[mask] > 0).any())
        hs = self._host_state.numpy()
        hs[_TOK], hs[_POS], hs[_ACT], hs[_EMIT] = self._tokens, self._pos, mask, self._emitted
        hs[_MAXNEW], hs[_SEED], hs[_TOPK] = self._max_new, self._seeds, self._topks
        hs[_TEMP] = self._temps.view(np.int32)
        hs[_POISON] = -1
        if poison[0] >= 0:
            hs[_POISON, poison[0]] = poison[1]
        hs[_BT:] = self._bt.T
        self._state.copy_(self._host_state)  # THE copy in
        if self.cuda_graph:
            graph, calls, launches = self._graph(tier, greedy)
            graph.replay()
            self.graph_replays += 1
            dispatch.add_replays(calls)
            for lib, n in launches.items():
                lib.replayed(n)
        else:
            self._block_body(tier, greedy)
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
        # only this pass's slots: the other tiers' rows ran frozen
        for s in np.nonzero((emits.any(axis=0) | quar) & mask)[0]:
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
        prompts to the chunked-prefill queue; shedding, degradation and
        preemption where configured), run up to ~one chunk's worth of
        prefill chunks, then one fused decode block per active tier; returns
        the requests that finished (or were shed) during this step.  With a
        watchdog, a step slower than its threshold bumps
        ``straggler_flags`` and emits a ``"straggler"`` event."""
        t0 = time.monotonic()
        with use_dispatch(self._dcfg):
            finished = self._step()
        if self.watchdog is not None and self.watchdog.observe(self._step_idx, time.monotonic() - t0):
            self.straggler_flags += 1
            if self.on_event is not None:
                self.on_event("straggler", {"step": self._step_idx, "seconds": round(self.watchdog.durations[-1], 6),
                                            "median_s": round(self.watchdog.median, 6)})
        return finished

    def _step(self) -> List[Request]:
        finished: List[Request] = []
        self._step_idx += 1
        if self.injector is not None:
            self.injector.on_step(self._step_idx)
        placed = self.scheduler.admit()
        if self.preempt:
            placed.extend(self._preempt_for_waiters())
        # deadline-expired waiters come back as finished, status "shed"
        finished.extend(self.scheduler.drain_shed())
        if placed:
            self.peak_active = max(self.peak_active, self.scheduler.allocator.n_active)
        chunking = self.paged and self.prefill_chunk is not None and self.model.prefill_chunk is not None
        direct = []
        for slot, req in placed:
            row = grant = None
            if self.paged:
                grant = self.scheduler.slot_pages[slot]
                row = np.full((self.max_pages,), self._trash, np.int32)
                row[: len(grant.pages)] = grant.pages
            if grant is not None and grant.start > 0:
                # a shared prefix: its K/V is resident, so the tail enters the
                # model mid-prompt through the chunk program, after the COW
                # copy of the page it re-writes (if any)
                if grant.cow is not None:
                    self._cow_fork(*grant.cow)
                self._chunking[slot] = [req, grant.start, row]
            elif chunking and req.prompt.size > self.prefill_chunk:
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
            # long prefill never stalls the running decodes for long, while
            # short shared tails pack into one step
            budget = self._chunk_C
            while self._chunking and budget > 0:
                done, n_real = self._chunk_step()
                finished.extend(done)
                budget -= max(n_real, 1)
        if not self._active.any():
            return finished
        # one fused block per active tier: a block's params must be every
        # advancing row's, so the other tiers' slots ride along frozen
        slot_tiers = np.array([r.tier if r is not None else 0 for r in self._reqs], np.int64)
        poison = self._poison_for()
        for tier in sorted({int(t) for t in slot_tiers[self._active]}):
            finished.extend(self._fused_pass(tier, self._active & (slot_tiers == tier), poison))
        return finished

    # ------------------------------------------------------------------ #
    # overload: preemption, eviction, the drain
    # ------------------------------------------------------------------ #
    @property
    def degraded_admissions(self) -> int:
        """Admissions the policy moved to a cheaper tier under pressure."""
        return self.scheduler.degraded

    def _poison_for(self) -> tuple:
        """The injector's NaN fault as (slot, step within the next block), or
        (-1, -1)."""
        if self.injector is None:
            return -1, -1
        return self.injector.poison_for(lambda s: self._reqs[s].uid if self._reqs[s] is not None else None,
                                        self.n_slots, self.steps, self.decode_block)

    def _pick_victim(self, head) -> Optional[int]:
        """The cheapest active slot the queue head strictly outranks: lowest
        priority, then fewest emitted tokens, then slot id.  Chunk-prefilling
        slots are never victims (their pages are half written)."""
        best, key = None, None
        for s in range(self.n_slots):
            req = self._reqs[s]
            if req is None or not self._active[s] or s in self._chunking or req.priority >= head.priority:
                continue
            k = (req.priority, int(self._emitted[s]), s)
            if key is None or k < key:
                best, key = s, k
        return best

    def _preempt_for_waiters(self) -> list:
        """While the queue head outranks a running request, preempt the
        cheapest victim and admit again; stop once an eviction admits no one
        (the victim's pages come back as warm cache, and its continuation
        queues right behind the preemptor)."""
        placed = []
        while self.scheduler.queue:
            victim = self._pick_victim(self.scheduler.queue[0])
            if victim is None:
                break
            self._preempt_slot(victim)
            more = self.scheduler.admit()
            if not more:
                break
            placed.extend(more)
        return placed

    def _evict_slot(self, slot: int) -> Request:
        """Evict one running request, keeping its work, and return the
        continuation that resumes it: prompt + tokens so far as a new
        prompt, the remaining budget, its extras (a vlm's image, an audio
        model's frames: the re-prefill attends them again), the original
        uid, submit time and tier.  With sharing, its decode-filled full
        pages are rewritten by the chunk program and indexed first, so the
        continuation matches
        them and prefills only its tail.  Greedy streams resume with the
        uninterrupted run's tokens where no argmax is a near tie between
        the prefill and decode paths' roundings; sampled streams restart
        their salt chain (``repro/serving/engine.py::_evict_slot``)."""
        req = self._reqs[slot]
        if self._share and len(req.tokens) > 1:
            self._register_session(slot, req)
        self._clear_slot(slot)
        root = req._parent if req._parent is not None else req
        if req._parent is not None:  # this segment's tokens join the root now
            root.tokens.extend(req.tokens)
        cont = Request(prompt=np.concatenate([req.prompt, np.asarray(req.tokens, np.int64)]),
                       max_new_tokens=req.max_new_tokens - len(req.tokens), sampling=req.sampling,
                       extras=req.extras, deadline_ms=req.deadline_ms, min_tier=req.min_tier, tier=req.tier,
                       priority=req.priority)
        cont.uid, cont.t_submit, cont._parent = req.uid, req.t_submit, root
        return cont

    def _preempt_slot(self, slot: int) -> None:
        """Preempt one running request for a higher-priority waiter: evict it
        and queue its continuation right behind the preemptor."""
        cont = self._evict_slot(slot)
        self.scheduler.queue.insert(1, cont)
        self.preemptions += 1
        if self.on_event is not None:
            self.on_event("preempt", {"uid": cont.uid, "emitted": len(cont._parent.tokens),
                                      "remaining": cont.max_new_tokens})

    def snapshot_inflight(self) -> List[dict]:
        """A read-only view of every in-flight request (chunk-prefilling and
        active slots)."""
        out = [{"uid": e[0].uid, "slot": slot, "emitted": 0, "remaining": e[0].max_new_tokens, "tier": e[0].tier,
                "chunking": True} for slot, e in self._chunking.items()]
        for slot, req in enumerate(self._reqs):
            if req is not None:
                out.append({"uid": req.uid, "slot": slot, "emitted": len(req.tokens),
                            "remaining": req.max_new_tokens - len(req.tokens), "tier": req.tier, "chunking": False})
        return out

    def take_queue(self) -> List[Request]:
        """Remove and return every queued (never admitted) request; the
        caller owns their completion from here."""
        out = list(self.scheduler.queue)
        self.scheduler.queue.clear()
        return out

    def export_inflight(self) -> List[Request]:
        """Evict every in-flight request and return what resumes it elsewhere:
        a chunk-prefilling request as it was submitted (it emitted nothing),
        an active one as its continuation (:meth:`_evict_slot`).  Every slot
        and page is released.  With sharing, the eviction rewrites decode-
        filled pages through the chunk program, so this runs under the
        engine's own dispatch config, as :meth:`step` does (the config is
        per thread, and a cluster's replica thread calls this outside a
        step)."""
        out: List[Request] = []
        with torch.no_grad(), use_dispatch(self._dcfg):
            for slot in list(self._chunking):
                req = self._chunking.pop(slot)[0]
                self._clear_slot(slot)
                out.append(req)
            for slot in range(self.n_slots):
                if self._reqs[slot] is not None:
                    out.append(self._evict_slot(slot))
        self.exported += len(out)
        return out

    def shed_queue(self, reason: str = "shutdown") -> List[Request]:
        """Shed every queued request with a :class:`RejectedOverload`; the
        in-flight ones are untouched (stop admitting, finish what runs)."""
        while self.scheduler.queue:
            self.scheduler.shed_request(self.scheduler.queue.popleft(), reason)
        return self.scheduler.drain_shed()

    def run(self, requests: Sequence[Request], arrivals: Optional[Sequence[float]] = None, *,
            max_idle_wait: float = 0.05, stop: Optional[Callable[[], bool]] = None) -> List[Request]:
        """Submit ``requests`` (optionally at wall-clock ``arrivals`` offsets,
        seconds) and step until all complete; returns them in finish order.
        Idle until the next arrival in naps of at most ``max_idle_wait``.
        ``stop``, polled once a loop: its first True starts a graceful drain
        (requests not yet submitted are dropped, the queue sheds with
        ``"shutdown"``, every in-flight request decodes to its end)."""
        order = sorted(range(len(requests)), key=lambda i: arrivals[i] if arrivals else 0)
        t0 = time.perf_counter()
        pending = list(order)
        finished: List[Request] = []
        while pending or self.has_work:
            if stop is not None and stop():
                pending.clear()
                finished.extend(self.shed_queue("shutdown"))
                stop = None  # drained once; the in-flight slots step on
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
