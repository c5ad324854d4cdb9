"""Slot and page allocation and FIFO request scheduling for the serving engine.

The port's own copy of the parts of ``repro/serving/scheduler.py`` that the
continuous-batching engine uses (pure Python and numpy; the port imports
nothing of the reference): :class:`SlotAllocator`, the refcounted
:class:`PageAllocator` with its warm cache, :class:`PageGrant`, the
:class:`PrefixIndex` of shared prompt pages, the FIFO :class:`Scheduler`
and its overload layer: :class:`AdmissionPolicy` (rank-tier degradation
under pressure, deadline shedding) and the :class:`RejectedOverload`
record a shed request carries; and the serving cluster's
:class:`RoutingPolicy` (least-loaded routing) and :class:`FailoverBudget`
(per-request failover retries with deterministic backoff).

The engine owns a fixed pool of ``n_slots`` cache slots.  Requests queue
FIFO; whenever a slot frees up, the scheduler admits the oldest waiting
request, so slot exhaustion queues work and never errors.  Paged mode adds
a :class:`PageAllocator` over the engine's physical KV pages: a request is
admitted only when its whole footprint
(``ceil((prompt + max_new) / page_size)`` pages, reserved up front so
decode never strands mid-stream) fits, and page exhaustion queues exactly
like slot exhaustion.  Admission stays strictly FIFO: a large request at
the head waits rather than being bypassed.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, Deque, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["SlotAllocator", "PageAllocator", "PageGrant", "PrefixIndex", "RejectedOverload", "AdmissionPolicy",
           "RoutingPolicy", "FailoverBudget", "Scheduler"]


class SlotAllocator:
    """Free-list allocator over ``n_slots`` cache slots.

    ``alloc`` returns the lowest free slot id (deterministic reuse order —
    important for reproducible traces) or None when exhausted.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # stack, lowest id on top
        self._active = [False] * n_slots

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def is_active(self, slot: int) -> bool:
        return self._active[slot]

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._active[slot] = True
        return slot

    def free(self, slot: int) -> None:
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if not self._active[slot]:
            raise ValueError(f"double free of slot {slot}")
        self._active[slot] = False
        # keep the free list sorted so reuse order stays deterministic
        self._free.append(slot)
        self._free.sort(reverse=True)


class PageAllocator:
    """Refcounted allocator over ``n_pages`` fixed-size KV-cache pages, with
    a warm cache of released pages whose contents are indexed.

    ``alloc(n)`` is ALL-OR-NOTHING: ``n`` pages at refcount 1 or None, never
    a partial grant.  Pages are unit-sized, so the pool cannot fragment.
    ``extend`` grows an allocation with the same contract.

    ``acquire(p)`` adds one READER: a live page gets one more reference; a
    cached page (refcount 0, back on the free list, contents intact because
    only ``alloc`` hands a page to a writer) is revived to refcount 1.  A
    shared page is counted ONCE in ``n_used``.  ``free`` DECREMENTS: a page
    returns to the free list only when its last reader releases it.  It
    validates the whole list (range, liveness, no duplicate ids) before
    mutating anything: ``free([p, p])`` would otherwise push ``p`` twice and
    a later ``alloc`` would grant one physical page to two slots.

    ``peak_used`` is raised inside the only two operations that grow usage
    (``alloc``, ``acquire``); ``reset_peak`` re-arms it to CURRENT usage;
    ``rollback_peak`` restores a mark after a failed reservation gave back
    every reference it took.

    WARM CACHE.  ``mark_indexed(pages)`` declares that a page's contents are
    keyed in a :class:`PrefixIndex`; when such a page's last reader releases
    it, it becomes a CACHED entry (on the free list, contents intact).
    ``alloc`` spends clean free pages first and only then EVICTS cached
    ones, the fewest rematch hits (``record_saved``) first and the oldest
    first within a count, announcing each eviction through ``on_evict``
    before the writer gets the page, so index keys and storage die
    together.  Recency is chain-aware: pages listed earlier in a
    ``free``/``mark_indexed`` call count as more recent (callers pass
    block-table order, and a chained index loses everything below a missing
    page).  ``cache_budget`` (None = unbounded) caps the cached entries; the
    excess is evicted on release.  An indexed page at refcount 0 is always
    a cached entry.  Without ``mark_indexed`` the allocator grants the
    lowest free ids first, as a plain free list.
    (The reference's ``repro/serving/scheduler.py:114-437``.)
    """

    def __init__(self, n_pages: int, *, cache_budget: Optional[int] = None,
                 on_evict: Optional[Callable[[List[int]], None]] = None):
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        if cache_budget is not None and cache_budget < 0:
            raise ValueError(f"cache_budget must be >= 0, got {cache_budget}")
        self.n_pages = n_pages
        self.cache_budget = cache_budget
        self.on_evict = on_evict
        # engine-thread-confined: mutated only from the owning engine's step loop
        self._free = list(range(n_pages - 1, -1, -1))  # stack, lowest id on top
        self._ref = [0] * n_pages
        self._peak = 0
        self._cached: "collections.OrderedDict[int, None]" = collections.OrderedDict()  # oldest first
        self._indexed: set = set()  # pages whose contents are index-keyed
        self._hits: dict = {}  # page -> admissions that mapped it instead of prefilling it
        self.evictions = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def peak_used(self) -> int:
        return self._peak

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def reset_peak(self) -> None:
        self._peak = self.n_used

    def rollback_peak(self, peak: int) -> None:
        """Restore a high-water mark taken before a reservation that FAILED
        and gave back every reference it took."""
        if not (self.n_used <= peak <= self._peak):
            raise ValueError(f"rollback_peak({peak}) with n_used={self.n_used}, peak_used={self._peak}: "
                             f"references were not rolled back")
        self._peak = peak

    def mark_indexed(self, pages) -> None:
        """Declare that ``pages`` back index entries (idempotent; marking a
        cached page refreshes its recency)."""
        pages = [int(p) for p in pages]
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"page {p} out of range [0, {self.n_pages})")
            self._indexed.add(p)
        for p in reversed(pages):  # earlier-listed pages outlive later ones, as in free()
            if self._ref[p] == 0:
                self._cached.pop(p, None)
                self._cached[p] = None  # most recently used
        self._enforce_budget()

    def flush_cache(self) -> None:
        """Forget every cached and indexed page, firing no ``on_evict`` and
        counting no eviction (the owner resets its index itself)."""
        self._cached.clear()
        self._indexed.clear()
        self._hits.clear()

    def drop_cached(self, pages) -> int:
        """Forget specific pages (a session close): cached ones become clean
        free pages, live ones lose their mark.  No ``on_evict``, no eviction
        counted.  Returns how many cached entries died."""
        n = 0
        for p in pages:
            p = int(p)
            self._indexed.discard(p)
            self._hits.pop(p, None)
            if p in self._cached:
                del self._cached[p]
                n += 1
        return n

    def _evict_victim(self) -> int:
        """Remove and return the cached page with the fewest rematch hits,
        the oldest first within a count (exact LRU with no hits recorded)."""
        victim, best = None, None
        for p in self._cached:  # insertion order == LRU order
            score = self._hits.get(p, 0)
            if score == 0:
                victim = p
                break
            if best is None or score < best:
                victim, best = p, score
        del self._cached[victim]
        self._indexed.discard(victim)
        self._hits.pop(victim, None)
        return victim

    def _announce(self, evicted: List[int]) -> None:
        if evicted:
            self.evictions += len(evicted)
            if self.on_evict is not None:
                self.on_evict(list(evicted))

    def _enforce_budget(self) -> None:
        if self.cache_budget is None:
            return
        evicted = []
        while len(self._cached) > self.cache_budget:
            evicted.append(self._evict_victim())
        self._announce(evicted)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        if not self._cached or n == 0:
            pages = [self._free.pop() for _ in range(n)]
        else:
            # clean pages first (lowest id first), then evict cached ones
            pages = sorted(p for p in self._free if p not in self._cached)[:n]
            evicted = []
            while len(pages) < n:
                evicted.append(self._evict_victim())
                pages.append(evicted[-1])
            self._announce(evicted)  # index keys die BEFORE the writer gets the page
            granted = set(pages)
            self._free = [p for p in self._free if p not in granted]
        for p in pages:
            self._ref[p] = 1
        self._peak = max(self._peak, self.n_used)
        return pages

    def acquire(self, page: int) -> bool:
        """Add a reader to ``page`` (share a live page, revive a cached one)."""
        if not (0 <= page < self.n_pages):
            return False
        if self._ref[page] == 0:
            try:
                self._free.remove(page)
            except ValueError:  # neither free nor referenced: cannot happen
                return False
            self._ref[page] = 1
            self._cached.pop(page, None)  # live again; re-cached on release
            self._peak = max(self._peak, self.n_used)
        else:
            self._ref[page] += 1
        return True

    def record_saved(self, pages) -> None:
        """Credit one rematch hit to each indexed page an ADMITTED reservation
        mapped (never a rolled-back one: a starved head-of-queue retry would
        inflate the weights every step)."""
        for p in pages:
            p = int(p)
            if p in self._indexed:
                self._hits[p] = self._hits.get(p, 0) + 1

    def extend(self, pages: List[int], n: int) -> Optional[List[int]]:
        """Grow an allocation in place by ``n`` pages (all-or-nothing).  The
        engine reserves a request's whole footprint up front, so only tests
        call this today."""
        more = self.alloc(n)
        if more is None:
            return None
        pages.extend(more)
        return pages

    def free(self, pages: List[int]) -> None:
        """Release one reference on every page in ``pages`` (validated whole
        before mutating)."""
        seen = set()
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"page {p} out of range [0, {self.n_pages})")
            if p in seen:
                raise ValueError(f"duplicate page {p} in free()")
            seen.add(p)
            if self._ref[p] < 1:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        # re-cache in REVERSE list order: earlier-listed pages (a chain's
        # head) end up more recent and outlive its deep tail
        for p in reversed(pages):
            if self._ref[p] == 0 and p in self._indexed:
                self._cached.pop(p, None)
                self._cached[p] = None
        self._free.sort(reverse=True)  # deterministic reuse order
        self._enforce_budget()


@dataclasses.dataclass
class PageGrant:
    """One admitted request's page reservation (the reserve-hook currency).

    ``pages``: the slot's block-table entries in logical order.  The leading
    ``n_shared`` are READ-ONLY shared prefix pages (the engine never writes
    through them).  ``start``: the first prompt position still to prefill
    (0 when nothing was shared).  ``cow``: an optional ``(src, dst)`` pair
    the engine copies BEFORE any write lands in ``dst`` (the copy-on-write
    fork of the last prefix page, when the tail re-enters it).  ``refs``:
    every page holding one of this grant's references, freed together on
    release: ``pages`` plus the COW source, pinned until the copy has run.
    An EMPTY grant is a real admission (zero-page archs); exhaustion is
    ``reserve`` returning None.
    """

    pages: List[int]
    n_shared: int = 0
    start: int = 0
    cow: Optional[Tuple[int, int]] = None
    refs: Optional[List[int]] = None

    def __post_init__(self):
        if self.refs is None:
            self.refs = list(self.pages)


class PrefixIndex:
    """Content index of FULL prompt-prefix pages for cross-request sharing.

    Page ``i``'s key commits to the whole prefix ``prompt[:(i + 1) *
    page_size]``: a CHAINED blake2b digest (16 bytes) of page ``i - 1``'s
    key and page ``i``'s tokens as int32 bytes, the reference's keys
    exactly.  ``match`` walks the longest chain of indexed pages from the
    prompt's head; a partial last page is never indexed.  Entries persist
    after their owner releases the pages (a warm cache); the allocator's
    ``on_evict`` drops them (``drop_pages``) when a page is re-granted to a
    writer or swept by the budget.  One key maps to at most one page and
    vice versa.  (The reference's ``repro/serving/scheduler.py:472-622``.)
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        # engine-thread-confined, like PageAllocator
        self._by_key: dict = {}
        self._by_page: dict = {}
        self._children: dict = {}  # parent key -> child keys, for branch drops

    def __len__(self) -> int:
        return len(self._by_key)

    def _page_keys(self, prompt) -> Iterator[bytes]:
        arr = np.ascontiguousarray(np.asarray(prompt).astype(np.int32))
        P = self.page_size
        key = b""
        for i in range(len(arr) // P):
            key = hashlib.blake2b(key + arr[i * P : (i + 1) * P].tobytes(), digest_size=16).digest()
            yield key

    def register(self, prompt, pages) -> List[int]:
        """Index every FULL page of ``prompt``; ``pages[i]`` holds positions
        ``[i * page_size, (i + 1) * page_size)`` (a block-table row works).
        The first registration of a key wins.  Returns the pages now backing
        the chain, for ``PageAllocator.mark_indexed``."""
        backing: List[int] = []
        prev = b""
        for i, key in enumerate(self._page_keys(prompt)):
            self._children.setdefault(prev, set()).add(key)
            prev = key
            page = self._by_key.get(key)
            if page is not None:  # same content already indexed
                backing.append(page)
                continue
            page = int(pages[i])
            old = self._by_page.pop(page, None)
            if old is not None:  # the page is re-registered under new content
                del self._by_key[old]
            self._by_key[key] = page
            self._by_page[page] = key
            backing.append(page)
        return backing

    def match(self, prompt) -> List[int]:
        """The longest chain of indexed full-prefix pages for ``prompt``."""
        chain: List[int] = []
        for key in self._page_keys(prompt):
            page = self._by_key.get(key)
            if page is None:
                break
            chain.append(page)
        return chain

    def drop_pages(self, pages) -> None:
        """Forget the entries of pages being re-granted to a writer."""
        for p in pages:
            key = self._by_page.pop(int(p), None)
            if key is not None:
                del self._by_key[key]
                self._children.pop(key, None)

    def drop_branch(self, prompt) -> List[int]:
        """Forget the prompt's chain and every registered extension of it (a
        session close); returns the pages whose entries died."""
        chain: List[bytes] = []
        for key in self._page_keys(prompt):
            if key not in self._by_key:
                break
            chain.append(key)
        if not chain:
            return []
        kill, stack = list(chain), [chain[-1]]
        while stack:
            for child in self._children.get(stack.pop(), ()):
                if child in self._by_key:  # linkage may outlive evictions
                    kill.append(child)
                    stack.append(child)
        dropped: List[int] = []
        for key in kill:
            page = self._by_key.pop(key, None)
            if page is not None:
                del self._by_page[page]
                dropped.append(page)
            self._children.pop(key, None)
        return dropped

    def clear(self) -> None:
        self._by_key.clear()
        self._by_page.clear()
        self._children.clear()


@dataclasses.dataclass(frozen=True)
class RejectedOverload:
    """The record a shed request carries: an explicit rejection the client can
    retry against, never silent starvation.  ``reason``: ``"deadline-expired"``
    or ``"shutdown"``; ``waited_ms``: its time in the queue; ``queue_depth``:
    the waiters (itself included) at the decision; ``deadline_ms``: its own
    admission deadline, if any."""

    uid: int
    reason: str
    waited_ms: float
    queue_depth: int
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class AdmissionPolicy:
    """Overload-aware admission: degrade the rank tier under pressure, shed
    deadline-expired waiters.

    Tier 0 is the full serving rank; higher tiers are nested cheaper ranks
    (prefix slices of the same factors, ``core.lowrank.slice_rank``).  Under
    pressure a new admission is served at the deepest tier its ``min_tier``
    allows instead of queueing, and carries that tier's certificate.
    Pressure is either signal: at least ``degrade_queue_depth`` waiters, or
    a free-page fraction below ``degrade_free_frac`` (``None`` disables a
    signal).  Under a policy the scheduler always drops waiters whose
    ``deadline_ms`` expired before admission, with a
    :class:`RejectedOverload` attached (the reference's ``shed_deadlines``
    is not carried over: nothing turns it off).
    """

    n_tiers: int = 1
    degrade_queue_depth: Optional[int] = None
    degrade_free_frac: Optional[float] = None

    def choose_tier(self, request, queue_depth: int, free_frac: float) -> int:
        base = int(getattr(request, "tier", 0))
        if self.n_tiers <= 1:
            return base
        if getattr(request, "_parent", None) is not None:
            # a preempted request resumes at the tier it started on: its
            # indexed K/V and its emitted tokens belong to that tier
            return base
        pressured = ((self.degrade_queue_depth is not None and queue_depth >= self.degrade_queue_depth)
                     or (self.degrade_free_frac is not None and free_frac < self.degrade_free_frac))
        if not pressured:
            return base
        return max(base, min(int(getattr(request, "min_tier", 0)), self.n_tiers - 1))


@dataclasses.dataclass
class RoutingPolicy:
    """Load-aware replica routing for the cluster's front door.

    ``pick`` takes one ``(replica_id, queue_depth, pages_used)`` triple per
    HEALTHY replica and returns the replica to route the next request to:
    least queue depth first (waiters dominate time to first token), then
    fewest pages in use (outstanding decode work), then the lowest id: a
    total order, so a deterministic trace routes deterministically.
    """

    def pick(self, loads: List[Tuple[int, int, int]]) -> int:
        if not loads:
            raise ValueError("no healthy replicas to route to")
        return min(loads, key=lambda t: (t[1], t[2], t[0]))[0]


@dataclasses.dataclass
class FailoverBudget:
    """Per-request failover accounting for the cluster.

    A request whose replica dies re-enters the shared queue at most
    ``max_failovers`` times, each time after capped exponential backoff with
    deterministic jitter (``runtime.fault_tolerance.backoff_s``'s formula,
    kept here too so this layer imports nothing else): attempt ``k`` waits
    ``min(base_ms * 2**k, cap_ms)`` scaled by a factor in [0.5, 1.0] hashed
    (blake2b) from ``(salt, k)``, salted with the request's uid so that
    concurrent failovers spread out instead of returning in lockstep.
    """

    max_failovers: int = 2
    base_ms: float = 0.0
    cap_ms: float = 250.0

    def backoff_ms(self, attempt: int, salt: int = 0) -> float:
        if self.base_ms <= 0:
            return 0.0
        raw = min(self.base_ms * (2.0 ** max(attempt, 0)), self.cap_ms)
        h = hashlib.blake2b(f"{salt}:{attempt}".encode(), digest_size=8).digest()
        frac = 0.5 + (int.from_bytes(h, "big") / 2.0**64) * 0.5
        return raw * frac


class Scheduler:
    """FIFO admission control on top of a :class:`SlotAllocator`.

    ``enqueue`` never blocks; ``admit`` drains the queue into free slots and
    returns the (slot, request) placements made this round.

    Paged engines additionally pass ``reserve``/``release_grant`` hooks:
    ``reserve(req)`` returns a grant (:class:`PageGrant`, possibly EMPTY) or
    ``None`` on exhaustion; the grant lands in ``slot_pages[slot]`` and is
    handed back to ``release_grant`` when the slot frees.  Exhaustion is
    detected with ``is None`` exclusively: an empty grant admits.

    An optional :class:`AdmissionPolicy` adds the overload layer: before each
    admission round deadline-expired waiters are shed (collected by
    :meth:`drain_shed`), and the head of the queue gets its tier from the
    policy's pressure signals before ``reserve`` sees it.  ``pressure``
    returns the free-resource fraction in [0, 1] (the engine's free pages).
    ``on_event(kind, fields)``, when set, receives a ``"shed"`` and a
    ``"degrade"`` event per decision.  With no policy the scheduler queues
    forever and never touches a tier.
    """

    def __init__(
        self,
        allocator: SlotAllocator,
        *,
        reserve: Optional[Callable[[object], Optional[object]]] = None,
        release_grant: Optional[Callable[[object], None]] = None,
        policy: Optional[AdmissionPolicy] = None,
        pressure: Optional[Callable[[], float]] = None,
    ):
        if (reserve is None) != (release_grant is None):
            raise ValueError("reserve and release_grant come together")
        self.allocator = allocator
        self.reserve = reserve
        self.release_grant = release_grant
        self.policy = policy
        self.pressure = pressure
        # engine-thread-confined: admission state is mutated only from the
        # owning engine's step loop
        self.slot_pages: dict = {}
        self.queue: Deque = collections.deque()
        self.shed: List = []
        self.degraded = 0  # admissions the policy moved to a cheaper tier
        self.on_event: Optional[Callable[[str, dict], None]] = None

    @property
    def n_waiting(self) -> int:
        return len(self.queue)

    def enqueue(self, request) -> None:
        self.queue.append(request)

    def drain_shed(self) -> List:
        """Hand back (and clear) the requests shed since the last drain."""
        out, self.shed = self.shed, []
        return out

    def shed_request(self, request, reason: str) -> None:
        """Mark one waiter (already popped) shed, with its rejection record."""
        now = time.perf_counter()
        request.status = "shed"
        request.t_done = now
        request.rejected = RejectedOverload(uid=request.uid, reason=reason, waited_ms=(now - request.t_submit) * 1e3,
                                            queue_depth=len(self.queue) + 1,
                                            deadline_ms=getattr(request, "deadline_ms", None))
        self.shed.append(request)
        if self.on_event is not None:
            self.on_event("shed", {"uid": request.uid, "reason": reason,
                                   "waited_ms": round(request.rejected.waited_ms, 3),
                                   "queue_depth": request.rejected.queue_depth})

    def _shed_expired(self) -> None:
        now = time.perf_counter()
        kept: Deque = collections.deque()
        while self.queue:
            req = self.queue.popleft()
            # a preempted continuation is exempt: the deadline governs
            # admission, and this request already emitted tokens
            dl = None if getattr(req, "_parent", None) is not None else getattr(req, "deadline_ms", None)
            if dl is not None and (now - req.t_submit) * 1e3 > dl:
                self.shed_request(req, "deadline-expired")
            else:
                kept.append(req)
        self.queue = kept

    def admit(self) -> List[Tuple[int, object]]:
        if self.policy is not None:
            self._shed_expired()
        placed = []
        while self.queue and self.allocator.n_free:
            req = self.queue[0]
            if self.policy is not None:
                free_frac = self.pressure() if self.pressure is not None else 1.0
                tier = self.policy.choose_tier(req, len(self.queue), free_frac)
                if tier > getattr(req, "tier", 0):
                    self.degraded += 1
                    req.tier = tier
                    if self.on_event is not None:
                        self.on_event("degrade", {"uid": req.uid, "tier": tier, "queue_depth": len(self.queue),
                                                  "free_frac": round(free_frac, 4)})
            if self.reserve is not None:
                grant = self.reserve(req)
                if grant is None:  # page exhaustion queues; strict FIFO
                    break
                slot = self.allocator.alloc()
                self.slot_pages[slot] = grant
            else:
                slot = self.allocator.alloc()
            placed.append((slot, self.queue.popleft()))
        return placed

    def release(self, slot: int) -> None:
        if self.reserve is not None:
            self.release_grant(self.slot_pages.pop(slot))
        self.allocator.free(slot)
