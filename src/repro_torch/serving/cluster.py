"""Replicated serving cluster: N engines, one front door, failover.

The port's counterpart of ``repro/serving/cluster.py``, with the same state
machine.  A :class:`Cluster` runs N :class:`~repro_torch.serving.engine.Engine`
replicas, each stepped by its own thread with its own paged pool and
captured decode blocks, behind one shared admission queue with load-aware
routing (:class:`~repro_torch.serving.scheduler.RoutingPolicy`: least queue
depth, then fewest pages in use).  On the card the replicas share the one
card and, through the factory, may share one set of weights; each replica
thread runs its engine on a CUDA stream of its own, so one replica's host
sync waits only for its own work, and the engine serializes CUDA-graph
captures and graph releases across the process
(``serving.engine.GRAPH_LOCK``).

Health is heartbeat-based.  Every replica thread beats after each engine
step (and while idle); each engine carries a
:class:`~repro_torch.runtime.fault_tolerance.StepWatchdog`, so the
monitor's per-replica deadline adapts to that replica's OBSERVED step times
(``max(heartbeat, straggler_factor x median, 1.25 x recent max)``) instead
of a fleet-wide constant.  A replica is declared dead when it (a) misses
its deadline (a hung device), (b) throws from its step loop (a killed
process: :class:`~repro_torch.runtime.fault_tolerance.ReplicaKilled` from
the injector, or a genuine bug), or (c) the watchdog flags a straggler step
above an absolute floor (a slow device).

Only the injector's host-side faults are recoverable on one card.  A CUDA
error (a kernel that fails to build or launch, an illegal address) is
sticky for the whole CUDA context, which every replica of the process
shares: the cluster would count it as one replica's death and fail its
work over, but no survivor can run either.  A test of the cluster on the
card therefore checks that every dead replica's ``step_error`` is the
injected :class:`ReplicaKilled` (or that none was raised: a hang).

Failover is BIT-EXACT under greedy decoding.  The cluster owns every
request's token stream: each submitted root request is served through
cluster-built SEGMENTS (fresh Request copies), and the tokens a dying
replica already emitted are credited to the root before a new segment
(``prompt = root.prompt + credited tokens``, ``max_new`` reduced) re-enters
the shared queue after capped-exponential backoff
(:class:`~repro_torch.serving.scheduler.FailoverBudget`, jitter salted by
the root uid).  Prefilling the extended prompt rematerializes the lost KV
(the mechanism engine preemption uses), so the survivor resumes
deterministically: the resumed tail is bit-identical to what any healthy
engine emits for that continuation, through a prefix match when it shares
cached pages (``prefill_skipped > 0``), through a cold re-prefill
otherwise.  Bit-exactness is per compute path: prefill-written and
decode-written KV can differ in low-order bits, so a resumed tail may
legitimately diverge from the UNINTERRUPTED replay at an argmax near-tie;
``resume_points`` records every split so that a verifier can replay each
continuation and check the resume exactly.  A request that exhausts its
budget surfaces a structured ``RejectedOverload(reason="replica_lost")``
instead of vanishing.

A dead-but-recovered replica (hang ended, straggler drained) re-enters
through PROBATION: its thread drains the engine (``take_queue`` +
``export_inflight``, results discarded: the cluster already owns those
streams; the drain releases slots and pages), beats while parked, and
rejoins the router after ``probation_s`` of clean beats.  A KILLED
replica's thread is gone, and stays gone across later ``run`` calls;
:meth:`Cluster.restart_replica` rebuilds its engine from the factory
(releasing the old engine's graphs) and walks it through the same probation
path, also while the other replicas serve.

The reference arms its runtime race sanitizer (``repro.analysis.sanitize``)
in ``start`` and ``close``; the port imports nothing of the reference, so
that is left out here.  The static lock-discipline pass still covers this
module through its ``# guarded by:`` annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.fault_tolerance import FaultInjector, StepWatchdog
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import FailoverBudget, RejectedOverload, RoutingPolicy

__all__ = ["Cluster", "EventLog"]


class EventLog:
    """Thread-safe JSON-lines event sink (``launch/serve.py --event-log PATH``).

    One line per event: ``{"t_ms": ..., "event": kind, ...fields}``.
    ``sink(**tags)`` returns an ``on_event(kind, fields)`` callable with the
    tags bound (the engine's and scheduler's hook shape), so every replica's
    events carry its id without the engine knowing about replicas.  Never
    raises into the serving path: a failed write drops the event, not the
    request.
    """

    def __init__(self, path: str):
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def emit(self, kind: str, fields: Optional[dict] = None) -> None:
        rec: dict = {"t_ms": round((time.perf_counter() - self._t0) * 1e3, 3), "event": kind}
        if fields:
            rec.update(fields)
        try:
            line = json.dumps(rec, default=str)
            with self._lock:
                self._f.write(line + "\n")
                self._f.flush()
        except (OSError, ValueError):
            pass

    def sink(self, **tags) -> Callable[[str, dict], None]:
        def on_event(kind: str, fields: dict) -> None:
            merged = dict(tags)
            merged.update(fields)
            self.emit(kind, merged)

        return on_event

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


class _Replica:
    """One engine, its stepping thread and stream, and health bookkeeping."""

    def __init__(self, rid: int, eng: Engine):
        self.id = rid
        self.eng = eng
        # the replica thread's CUDA stream (None on the CPU)
        self.stream = torch.cuda.Stream(eng.device) if eng.device.type == "cuda" else None
        self.thread: Optional[threading.Thread] = None
        self.inbox_lock = threading.Lock()
        self.health_lock = threading.Lock()
        self.inbox: List[Request] = []  # guarded by: inbox_lock
        # Health fields cross the replica-thread/monitor boundary in both
        # directions; everything below health_lock's annotations is
        # single-writer and confined to one side of that boundary.
        self.state_cmd = "run"  # guarded by: health_lock
        self.drained = False  # guarded by: health_lock
        self.step_error: Optional[BaseException] = None  # guarded by: health_lock
        self.last_beat = time.monotonic()  # guarded by: health_lock
        # monitor-thread-confined ("healthy" | "dead" | "probation"):
        # only check_health/_mark_dead/restart_replica transition it
        self.state = "healthy"
        self.step_count = 0  # replica-thread-confined (the injector's clock)
        self.straggler_seen = 0  # monitor-confined: flags already examined
        self.deaths = 0  # monitor-confined
        self.rejoin_t = 0.0  # monitor-confined

    @property
    def thread_alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def spawn(self, target) -> None:
        """Start the replica thread.  Its stream first waits for the calling
        thread's: the engine's tensors were built (and maybe warmed) there."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.eng.device))
        self.thread = threading.Thread(target=target, args=(self,), daemon=True)
        self.thread.start()


class _Tracked:
    """Cluster-side record of one root request's serving state."""

    __slots__ = ("root", "emitted", "attempts", "cur", "replica", "retry_at", "done", "t_first", "tier", "prefix_hit")

    def __init__(self, root: Request):
        self.root = root
        self.emitted: List[int] = []  # tokens credited from prior segments
        self.attempts = 0  # failovers consumed
        self.cur: Optional[Request] = None  # live segment (engine-owned copy)
        self.replica = -1
        self.retry_at = 0.0  # monotonic time the next segment may route
        self.done = False
        self.t_first = 0.0
        self.tier = root.tier
        self.prefix_hit = False  # a resumed segment prefix-matched pages


class Cluster:
    """N engine replicas behind one shared admission queue.

    ``factory(replica_id) -> Engine`` builds each replica's engine (its own
    pool and captured blocks; the factory may share one ``model, params``
    across replicas); the cluster attaches a :class:`StepWatchdog` and the
    event sink if the factory did not.  ``injector`` is shared across
    replicas: replica-level faults (``kill_replica`` / ``hang_replica`` /
    ``slow_replica``) key on the replica id and that replica's LOCAL step
    counter through ``on_replica_step``.
    """

    def __init__(
        self,
        factory: Callable[[int], Engine],
        n_replicas: int,
        *,
        heartbeat_ms: float = 1000.0,
        budget: Optional[FailoverBudget] = None,
        routing: Optional[RoutingPolicy] = None,
        injector: Optional[FaultInjector] = None,
        probation_s: float = 0.25,
        cold_grace_s: float = 30.0,
        straggler_min_s: float = 0.5,
        event_log: Optional[EventLog] = None,
        poll_s: float = 0.002,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._factory = factory
        self.heartbeat_ms = heartbeat_ms
        self.budget = budget if budget is not None else FailoverBudget()
        self.routing = routing if routing is not None else RoutingPolicy()
        self.injector = injector
        self.probation_s = probation_s
        self.cold_grace_s = cold_grace_s
        self.straggler_min_s = straggler_min_s
        self.event_log = event_log
        self._poll_s = poll_s

        self._lock = threading.Lock()
        self._uid = 0  # guarded by: _lock
        self._tracked: List[_Tracked] = []  # guarded by: _lock
        self._by_seg: Dict[int, _Tracked] = {}  # guarded by: _lock
        self._pending: List[_Tracked] = []  # guarded by: _lock
        self._finished: List[Request] = []  # guarded by: _lock
        # one-way lock-free flags: set once by the controlling thread,
        # polled by replica threads (a stale read costs one extra loop)
        self._shutdown = False
        self._draining = False

        # cluster-level accounting; read live through stats() (raw
        # attribute reads need _lock)
        self.failovers = 0  # guarded by: _lock
        self.failovers_prefix_match = 0  # guarded by: _lock
        self.heartbeat_misses = 0  # guarded by: _lock
        self.replica_deaths = 0  # guarded by: _lock
        self.rejoins = 0  # guarded by: _lock
        self.exhausted = 0  # guarded by: _lock
        # uid -> emitted lengths at each failover, in order: the resume
        # split points a verifier needs to replay each continuation
        self.resume_points: Dict[int, List[int]] = {}  # guarded by: _lock

        self.replicas = [_Replica(rid, self._prepare(self._factory(rid), rid)) for rid in range(n_replicas)]

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #
    def _prepare(self, eng: Engine, rid: int) -> Engine:
        if eng.watchdog is None:
            eng.watchdog = StepWatchdog()
        if self.event_log is not None and eng.on_event is None:
            sink = self.event_log.sink(replica=rid)
            eng.on_event = sink
            eng.scheduler.on_event = sink
        return eng

    def _log(self, kind: str, **fields) -> None:
        if self.event_log is not None:
            self.event_log.emit(kind, fields)

    def start(self) -> None:
        """Spawn any replica thread not already running, but a killed one's: a
        replica whose thread died of a step error stays down until
        :meth:`restart_replica` rebuilds its engine.  (The reference respawns
        it on the dead engine, where it can never rejoin, since its error
        stays set, and ``restart_replica`` then refuses it as alive; so a
        second ``run`` before the restart strands it there, not here.)"""
        for rep in self.replicas:
            with rep.health_lock:
                killed = rep.step_error is not None
            if not rep.thread_alive and not (rep.state == "dead" and killed):
                rep.spawn(self._replica_loop)

    def close(self) -> None:
        """Stop every replica thread (idempotent); the calling thread's
        stream then waits for the replicas' streams."""
        self._shutdown = True
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=5.0)
            if rep.stream is not None:
                torch.cuda.current_stream(rep.eng.device).wait_stream(rep.stream)

    # ------------------------------------------------------------------ #
    # submission / segments
    # ------------------------------------------------------------------ #
    def submit(self, request: Request) -> Request:
        """Accept one root request; returns it (uid and t_submit assigned).

        The root object is the CLIENT's handle: it is never handed to an
        engine (engines mutate what they serve); segments are fresh copies
        and the root's stream and terminal state are written back by the
        cluster at completion.
        """
        with self._lock:
            request.uid = self._uid
            self._uid += 1
            request.t_submit = time.perf_counter()
            tr = _Tracked(request)
            self._tracked.append(tr)
            self._pending.append(tr)
        return request

    def _make_segment(self, tr: _Tracked) -> Request:
        root = tr.root
        prompt = np.concatenate([root.prompt, np.asarray(tr.emitted, np.int64)]) if tr.emitted else root.prompt
        return Request(
            prompt=prompt,
            max_new_tokens=root.max_new_tokens - len(tr.emitted),
            sampling=root.sampling,
            extras=root.extras,
            # a resumed segment already delivered tokens: shedding it on
            # admission latency would discard work (the exemption the engine
            # gives its own preemption continuations)
            deadline_ms=root.deadline_ms if not tr.emitted else None,
            min_tier=root.min_tier,
            tier=tr.tier,
            priority=root.priority,
        )

    # ------------------------------------------------------------------ #
    # replica thread
    # ------------------------------------------------------------------ #
    def _replica_loop(self, rep: _Replica) -> None:
        ctx = torch.cuda.stream(rep.stream) if rep.stream is not None else contextlib.nullcontext()
        with ctx:
            self._replica_steps(rep)

    def _replica_steps(self, rep: _Replica) -> None:
        eng = rep.eng
        while not self._shutdown:
            with rep.health_lock:
                cmd = rep.state_cmd
                drained = rep.drained
            if cmd == "drain":
                if not drained:
                    with rep.inbox_lock:
                        rep.inbox = []
                    try:
                        # release every slot and page; the cluster owns the
                        # streams, so the drained work is DISCARDED here
                        eng.take_queue()
                        eng.export_inflight()
                    except Exception as e:  # engine too broken to drain
                        with rep.health_lock:
                            rep.step_error = rep.step_error or e
                    with rep.health_lock:
                        rep.drained = True
                    self._log("replica_drained", replica=rep.id, pages_used=eng.pages_in_use if eng.paged else 0)
                with rep.health_lock:
                    rep.last_beat = time.monotonic()
                time.sleep(self._poll_s)
                continue

            with rep.inbox_lock:
                inbox, rep.inbox = rep.inbox, []
            for seg in inbox:
                eng.submit(seg)
            if self._draining:
                for req in eng.shed_queue("shutdown"):
                    self._on_done(rep, req)

            if eng.has_work:
                try:
                    rep.step_count += 1
                    if self.injector is not None:
                        self.injector.on_replica_step(rep.id, rep.step_count)
                    with rep.health_lock:
                        cmd = rep.state_cmd
                    if cmd == "drain":
                        # a hang fault parked us long enough for the monitor
                        # to declare us dead: do NOT step a replica whose
                        # work already failed over
                        continue
                    finished = eng.step()
                except Exception as e:
                    with rep.health_lock:
                        rep.step_error = e
                    return  # the thread dies; the monitor declares us dead
                with rep.health_lock:
                    rep.last_beat = time.monotonic()
                for req in finished:
                    self._on_done(rep, req)
            else:
                with rep.health_lock:
                    rep.last_beat = time.monotonic()
                time.sleep(self._poll_s)

    def _on_done(self, rep: _Replica, req: Request) -> None:
        """Replica thread: one segment finished (completed, errored, or shed
        by the engine's own admission layer)."""
        with self._lock:
            tr = self._by_seg.pop(id(req), None)
            if tr is None and req._parent is not None:
                # an engine-internal preemption continuation shed at shutdown
                # surfaces raw; its root is the tracked segment
                tr = self._by_seg.pop(id(req._parent), None)
                if tr is not None:
                    req._parent.status = req.status
                    req._parent.rejected = req.rejected
                    req = req._parent
            if tr is None or tr.done:
                return  # a zombie: this segment already failed over
            self._credit(tr, req)
            if req.status == "shed":
                self._finish_root(tr, status="shed", rejected=req.rejected, t_done=req.t_done)
            else:
                if tr.attempts > 0:
                    self._log("failover_resumed", uid=tr.root.uid, replica=rep.id, attempt=tr.attempts,
                              prefix_match=req.prefill_skipped > 0)
                self._finish_root(tr, status=req.status, error=req.error, certificate=req.certificate,
                                  t_done=req.t_done)

    def _credit(self, tr: _Tracked, seg: Request) -> None:
        """Fold a segment's delivered tokens and metadata into the record
        (lock held)."""
        tr.emitted.extend(seg.tokens)
        tr.tier = max(tr.tier, seg.tier)
        if seg.t_first and not tr.t_first:
            tr.t_first = seg.t_first
        if tr.attempts > 0 and seg.prefill_skipped > 0 and not tr.prefix_hit:
            tr.prefix_hit = True
            self.failovers_prefix_match += 1

    def _finish_root(self, tr: _Tracked, *, status: str, rejected: Optional[RejectedOverload] = None,
                     error: Optional[str] = None, certificate=None, t_done: Optional[float] = None) -> None:
        """Write the record back onto the client's root object (lock held)."""
        root = tr.root
        root.tokens[:] = tr.emitted
        root.status = status
        root.error = error
        root.tier = tr.tier
        if certificate is not None:
            root.certificate = certificate
        if rejected is not None:
            root.rejected = dataclasses.replace(rejected, uid=root.uid)
        if tr.t_first:
            root.t_first = tr.t_first
        root.t_done = t_done if t_done else time.perf_counter()
        tr.done = True
        tr.cur = None
        self._finished.append(root)

    # ------------------------------------------------------------------ #
    # monitor: routing and health (the controlling thread)
    # ------------------------------------------------------------------ #
    def _healthy(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == "healthy"]

    def _route_due(self) -> None:
        now = time.monotonic()
        healthy = self._healthy()
        if not healthy:
            # nothing to route to; pending work waits for a probation rejoin
            # or a restart, or check_health sheds it when every replica is
            # dead for good
            return
        by_id = {r.id: r for r in healthy}
        while True:
            with self._lock:
                idx = next((i for i, tr in enumerate(self._pending) if tr.retry_at <= now), None)
                if idx is None:
                    return
                tr = self._pending.pop(idx)
                seg = self._make_segment(tr)
                loads = []
                for r in healthy:
                    # the replica thread swaps its inbox concurrently: its
                    # length is read under the inbox's lock
                    with r.inbox_lock:
                        depth = len(r.inbox)
                    loads.append((r.id, depth + r.eng.n_waiting,
                                  r.eng.pages_in_use if r.eng.paged else r.eng.n_active))
                rid = self.routing.pick(loads)
                tr.cur = seg
                tr.replica = rid
                self._by_seg[id(seg)] = tr
            rep = by_id[rid]
            with rep.inbox_lock:
                rep.inbox.append(seg)

    def _deadline_s(self, rep: _Replica) -> float:
        base = self.heartbeat_ms / 1e3
        wd = rep.eng.watchdog
        if wd is None or not wd.durations:
            # a cold replica: its first steps build kernels and capture
            # graphs, so do not declare death on that latency
            return max(base, self.cold_grace_s)
        recent = wd.durations[-wd.window:]
        return max(base, wd.straggler_factor * wd.median, 1.25 * max(recent))

    def check_health(self) -> None:
        """One monitor pass: detect deaths, walk recoveries through
        probation back to healthy.  Called from the run loop; callable
        directly by tests driving the cluster by hand."""
        now = time.monotonic()
        for rep in self.replicas:
            # snapshot the thread-shared health fields once, then decide
            with rep.health_lock:
                err = rep.step_error
                beat = rep.last_beat
                drained = rep.drained
            if rep.state == "healthy":
                reason = None
                if err is not None:
                    reason = f"step-error:{type(err).__name__}"
                elif now - beat > self._deadline_s(rep):
                    with self._lock:
                        self.heartbeat_misses += 1
                    reason = "heartbeat-miss"
                else:
                    flags = rep.eng.straggler_flags
                    if flags > rep.straggler_seen:
                        rep.straggler_seen = flags
                        wd = rep.eng.watchdog
                        if wd is not None and wd.durations and wd.durations[-1] > self.straggler_min_s:
                            reason = "straggler"
                if reason is not None:
                    self._mark_dead(rep, reason)
            elif rep.state == "dead":
                if rep.thread_alive and drained and err is None and now - beat <= self._deadline_s(rep):
                    rep.state = "probation"
                    rep.rejoin_t = now + self.probation_s
                    self._log("replica_probation", replica=rep.id)
            elif rep.state == "probation":
                if now >= rep.rejoin_t:
                    rep.state = "healthy"
                    rep.straggler_seen = rep.eng.straggler_flags
                    with rep.health_lock:
                        rep.state_cmd = "run"
                        rep.last_beat = now
                    with self._lock:
                        self.rejoins += 1
                    self._log("replica_rejoin", replica=rep.id)
        if not any(r.state != "dead" for r in self.replicas):
            self._shed_all("replica_lost")

    def _mark_dead(self, rep: _Replica, reason: str) -> None:
        rep.state = "dead"
        with rep.health_lock:
            rep.state_cmd = "drain"
            rep.drained = False
        rep.deaths += 1
        self._log("replica_dead", replica=rep.id, reason=reason)
        now = time.monotonic()
        with self._lock:
            self.replica_deaths += 1
            victims = [(key, tr) for key, tr in self._by_seg.items() if tr.replica == rep.id]
            for key, tr in victims:
                del self._by_seg[key]
                self._fail_over(tr, reason, now)

    def _fail_over(self, tr: _Tracked, reason: str, now: float) -> None:
        """Credit the dying segment's tokens and re-enqueue or reject (lock
        held)."""
        seg = tr.cur
        if seg is not None:
            # the replica thread appends tokens but never removes them, so a
            # read under the GIL is always a valid prefix
            self._credit(tr, seg)
        tr.cur = None
        tr.replica = -1
        root = tr.root
        if len(tr.emitted) >= root.max_new_tokens:
            # the replica died BETWEEN the last token and its completion
            # bookkeeping: everything was delivered, so finish, not retry
            self._finish_root(tr, status="ok")
            return
        if tr.attempts >= self.budget.max_failovers:
            self.exhausted += 1
            pc = time.perf_counter()
            self._finish_root(tr, status="shed",
                              rejected=RejectedOverload(uid=root.uid, reason="replica_lost",
                                                        waited_ms=(pc - root.t_submit) * 1e3,
                                                        queue_depth=len(self._pending), deadline_ms=root.deadline_ms),
                              t_done=pc)
            self._log("failover_exhausted", uid=root.uid, attempts=tr.attempts, emitted=len(tr.emitted))
            return
        delay_ms = self.budget.backoff_ms(tr.attempts, salt=root.uid)
        tr.attempts += 1
        tr.retry_at = now + delay_ms / 1e3
        self.failovers += 1
        self.resume_points.setdefault(root.uid, []).append(len(tr.emitted))
        self._pending.append(tr)
        self._log("failover", uid=root.uid, attempt=tr.attempts, emitted=len(tr.emitted),
                  backoff_ms=round(delay_ms, 3), reason=reason)

    def _shed_all(self, reason: str) -> None:
        """Every replica is dead: fail what is open rather than hang."""
        with self._lock:
            open_now = [tr for tr in self._tracked if not tr.done]
            self._pending = []
            self._by_seg.clear()
            pc = time.perf_counter()
            for tr in open_now:
                if tr.cur is not None:
                    self._credit(tr, tr.cur)
                    tr.cur = None
                self.exhausted += 1
                self._finish_root(tr, status="shed",
                                  rejected=RejectedOverload(uid=tr.root.uid, reason=reason,
                                                            waited_ms=(pc - tr.root.t_submit) * 1e3, queue_depth=0,
                                                            deadline_ms=tr.root.deadline_ms),
                                  t_done=pc)

    def restart_replica(self, rid: int) -> None:
        """Rebuild a KILLED replica (thread dead) from the factory and re-enter
        it through the probation path.  The dead engine's captured graphs are
        released first (``Engine.close``, under the engine's process-wide
        graph lock), so no other replica's capture sees a graph exec
        destroyed."""
        rep = self.replicas[rid]
        if rep.thread_alive:
            raise RuntimeError(f"replica {rid} thread is still alive")
        if rep.stream is not None:
            # a step that raised may have left a replay in flight, and a
            # released graph's memory pool goes back to the allocator
            rep.stream.synchronize()
        rep.eng.close()
        rep.eng = self._prepare(self._factory(rid), rid)
        rep.step_count = 0
        rep.straggler_seen = 0
        rep.state = "dead"
        with rep.health_lock:
            rep.step_error = None
            rep.state_cmd = "drain"
            rep.drained = True  # a fresh engine holds nothing to drain
            rep.last_beat = time.monotonic()
        with rep.inbox_lock:
            rep.inbox = []
        rep.spawn(self._replica_loop)
        self._log("replica_restart", replica=rid)

    # ------------------------------------------------------------------ #
    # drive loop
    # ------------------------------------------------------------------ #
    @property
    def n_open(self) -> int:
        with self._lock:
            return sum(1 for tr in self._tracked if not tr.done)

    def stats(self) -> Dict[str, object]:
        """Locked snapshot of the failover accounting: the safe way to read
        the counters while replica threads are live."""
        with self._lock:
            return {
                "failovers": self.failovers,
                "failovers_prefix_match": self.failovers_prefix_match,
                "heartbeat_misses": self.heartbeat_misses,
                "replica_deaths": self.replica_deaths,
                "rejoins": self.rejoins,
                "exhausted": self.exhausted,
                "resume_points": {uid: list(pts) for uid, pts in self.resume_points.items()},
            }

    def run(
        self,
        requests: Sequence[Request],
        arrivals: Optional[Sequence[float]] = None,
        *,
        stop: Optional[Callable[[], bool]] = None,
        timeout_s: Optional[float] = None,
    ) -> List[Request]:
        """Submit ``requests`` (optionally at ``arrivals`` offsets, seconds)
        and route and monitor until every root completes; returns the roots
        in finish order.  ``Engine.run``'s contract, graceful shutdown
        included: the first ``stop() == True`` drops unsubmitted requests,
        sheds the shared queue with ``"shutdown"`` rejections, and lets
        in-flight segments decode to completion.  ``timeout_s`` is a test
        guard: its expiry sheds everything open and returns (a wedged
        cluster fails an assertion instead of hanging).
        """
        self.start()
        order = sorted(range(len(requests)), key=lambda i: arrivals[i] if arrivals else 0)
        pending = list(order)
        t0 = time.perf_counter()
        while True:
            now_rel = time.perf_counter() - t0
            if timeout_s is not None and now_rel > timeout_s:
                self._shed_all("cluster_timeout")
                break
            if stop is not None and stop():
                pending.clear()
                self._begin_drain()
                stop = None
            while pending and (arrivals is None or arrivals[pending[0]] <= now_rel):
                self.submit(requests[pending[0]])
                pending.pop(0)
            self._route_due()
            self.check_health()
            if not pending and self.n_open == 0:
                break
            time.sleep(self._poll_s)
        with self._lock:
            out, self._finished = self._finished, []
        return out

    def _begin_drain(self) -> None:
        """Graceful shutdown: shed everything not yet on a replica; the
        replica threads shed their engine queues and finish in-flight work."""
        self._draining = True
        with self._lock:
            waiting, self._pending = self._pending, []
            pc = time.perf_counter()
            for tr in waiting:
                self._finish_root(tr, status="shed",
                                  rejected=RejectedOverload(uid=tr.root.uid, reason="shutdown",
                                                            waited_ms=(pc - tr.root.t_submit) * 1e3,
                                                            queue_depth=len(waiting), deadline_ms=tr.root.deadline_ms),
                                  t_done=pc)
