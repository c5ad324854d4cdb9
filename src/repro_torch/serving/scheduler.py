"""Slot and page allocation and FIFO request scheduling for the serving engine.

The port's own copy of the parts of ``repro/serving/scheduler.py`` that the
continuous-batching engine uses (pure Python and numpy; the port imports
nothing of the reference): :class:`SlotAllocator`, the
:class:`PageAllocator`, :class:`PageGrant` and the FIFO :class:`Scheduler`.
The reference scheduler's overload layer (admission policy, deadline
shedding), the prefix index and the allocator's refcounted sharing and warm
cache come with the slices that port prefix sharing and overload handling.

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
from typing import Callable, Deque, List, Optional, Tuple

__all__ = ["SlotAllocator", "PageAllocator", "PageGrant", "Scheduler"]


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
    """Allocator over ``n_pages`` fixed-size KV-cache pages.

    ``alloc(n)`` is ALL-OR-NOTHING: it returns the ``n`` lowest free page
    ids (deterministic reuse order, mirroring :class:`SlotAllocator`) or
    None — never a partial grant, so a request can never be admitted into a
    half-backed cache.  Pages are unit-sized, so the pool cannot fragment:
    any ``n <= n_free`` request succeeds.

    ``free`` validates the WHOLE list — range, liveness, and no duplicate
    ids — before mutating anything.  (Without the duplicate check,
    ``free([p, p])`` would push ``p`` onto the free list twice, and a later
    ``alloc`` would grant the same physical page to two slots — silent KV
    aliasing.)

    ``peak_used`` is the high-water mark, raised inside ``alloc``, the only
    operation that grows usage.  ``reset_peak`` re-arms it to CURRENT
    usage, not zero: pages held across a counter reset stay observed.

    The reference's allocator also refcounts shared prefix pages and keeps
    a warm cache of released ones; those parts come with the slice that
    ports prefix sharing.  Without them the two give the same grants.
    """

    def __init__(self, n_pages: int):
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        self.n_pages = n_pages
        # engine-thread-confined: mutated only from the owning engine's step loop
        self._free = list(range(n_pages - 1, -1, -1))  # stack, lowest id on top
        self._used = [False] * n_pages
        self._peak = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def peak_used(self) -> int:
        return self._peak

    def reset_peak(self) -> None:
        self._peak = self.n_used

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._used[p] = True
        self._peak = max(self._peak, self.n_used)
        return pages

    def free(self, pages: List[int]) -> None:
        """Release every page in ``pages`` (validated whole before mutating)."""
        seen = set()
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"page {p} out of range [0, {self.n_pages})")
            if p in seen:
                raise ValueError(f"duplicate page {p} in free()")
            seen.add(p)
            if not self._used[p]:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._used[p] = False
            self._free.append(p)
        self._free.sort(reverse=True)  # deterministic reuse order


@dataclasses.dataclass
class PageGrant:
    """One admitted request's page reservation (the reserve-hook currency).

    ``pages`` — the slot's block-table entries in logical order (length ==
    the request's page need), freed together on release.  An EMPTY grant
    (``pages == []``) is a real admission; exhaustion is signalled by
    ``reserve`` returning ``None``, never by emptiness.  The reference's
    grant also carries the shared-prefix fields (``n_shared``, ``start``,
    ``cow``, ``refs``), which come with prefix sharing.
    """

    pages: List[int]


class Scheduler:
    """FIFO admission control on top of a :class:`SlotAllocator`.

    ``enqueue`` never blocks; ``admit`` drains the queue into free slots and
    returns the (slot, request) placements made this round.

    Paged engines additionally pass ``reserve``/``release_grant`` hooks:
    ``reserve(req)`` returns a grant (:class:`PageGrant`, possibly EMPTY) or
    ``None`` on exhaustion; the grant lands in ``slot_pages[slot]`` and is
    handed back to ``release_grant`` when the slot frees.  Exhaustion is
    detected with ``is None`` exclusively: an empty grant admits.
    """

    def __init__(
        self,
        allocator: SlotAllocator,
        *,
        reserve: Optional[Callable[[object], Optional[object]]] = None,
        release_grant: Optional[Callable[[object], None]] = None,
    ):
        if (reserve is None) != (release_grant is None):
            raise ValueError("reserve and release_grant come together")
        self.allocator = allocator
        self.reserve = reserve
        self.release_grant = release_grant
        # engine-thread-confined: admission state is mutated only from the
        # owning engine's step loop
        self.slot_pages: dict = {}
        self.queue: Deque = collections.deque()

    @property
    def n_waiting(self) -> int:
        return len(self.queue)

    def enqueue(self, request) -> None:
        self.queue.append(request)

    def admit(self) -> List[Tuple[int, object]]:
        placed = []
        while self.queue and self.allocator.n_free:
            req = self.queue[0]
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
