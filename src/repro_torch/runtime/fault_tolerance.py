"""Step-time watchdog, retries with backoff, and deterministic fault injection.

The port's own copy of the serving half of ``repro/runtime/fault_tolerance.py``:
:class:`StepWatchdog` (straggler detection against a rolling median of step
times), :func:`backoff_s` and :class:`RetryableStep` (bounded retries with
capped-exponential backoff and deterministic jitter), :class:`ReplicaKilled`,
and :class:`FaultInjector` with its engine-level fault classes
(``nan_logits``, ``deny_pages``, ``slow_steps``) and its replica-level ones
(``kill_replica``, ``hang_replica``, ``slow_replica``), which the serving
cluster (:mod:`repro_torch.serving.cluster`) applies, and
:class:`TrainLoopRunner`, the checkpoint-restart training loop, and
:class:`ElasticReshard`, which lays a state restored on the host onto a mesh
that may differ from the one that saved it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["StepWatchdog", "RetryableStep", "FaultInjector", "ReplicaKilled", "backoff_s", "TrainLoopRunner",
           "ElasticReshard"]


def backoff_s(attempt: int, *, base_s: float, cap_s: float, salt: int = 0) -> float:
    """Capped exponential backoff with DETERMINISTIC jitter: ``base_s *
    2**attempt`` capped at ``cap_s``, scaled by a factor in [0.5, 1.0] hashed
    (blake2b) from ``(salt, attempt)``, so retries of different salts spread
    out while every run of one (salt, attempt) sleeps the same time, to the
    bit of the reference's (no global RNG state)."""
    if base_s <= 0:
        return 0.0
    raw = min(base_s * (2.0 ** max(attempt, 0)), cap_s)
    h = hashlib.blake2b(f"{salt}:{attempt}".encode(), digest_size=8).digest()
    frac = 0.5 + (int.from_bytes(h, "big") / 2.0**64) * 0.5
    return raw * frac


@dataclasses.dataclass
class StepWatchdog:
    """Step-time statistics and straggler detection: a step slower than
    ``straggler_factor`` x the median of the ``window`` steps before it is
    flagged (never within the first five, while the median is not yet
    trustworthy); a sustained slowdown re-baselines as the window rolls."""

    straggler_factor: float = 3.0
    window: int = 50

    def __post_init__(self):
        self.durations: list = []
        self.straggler_steps: list = []

    def observe(self, step: int, seconds: float) -> bool:
        self.durations.append(seconds)
        hist = self.durations[-self.window:]
        med = float(np.median(hist[:-1])) if len(hist) > 1 else seconds
        is_straggler = len(hist) > 5 and seconds > self.straggler_factor * med
        if is_straggler:
            self.straggler_steps.append(step)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.durations[-self.window:])) if self.durations else 0.0


class RetryableStep:
    """Wrap a step function with bounded retries and capped-exponential backoff.

    After ``max_retries`` consecutive failures of a ``retryable`` class the
    last error propagates; any other error passes through at once.  Backoff
    is off by default (``base_delay_s=0``: hot retries); armed, attempt ``k``
    sleeps ``backoff_s(k, base_s, cap_s, salt=jitter_salt)``, never after the
    final failure.  ``sleep`` is injectable, so tests record the delays.
    """

    def __init__(self, fn: Callable, *, max_retries: int = 2, retryable=(Exception,), base_delay_s: float = 0.0,
                 max_delay_s: float = 1.0, jitter_salt: int = 0, sleep: Callable[[float], None] = time.sleep):
        self.fn, self.max_retries, self.retryable = fn, max_retries, retryable
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter_salt = jitter_salt
        self._sleep = sleep
        self.total_retries = 0  # failures observed (the final one too)
        self.total_attempts = 0  # calls into fn
        self.backoffs = 0  # sleeps taken
        self.total_backoff_s = 0.0

    def __call__(self, *args, **kw):
        for attempt in range(self.max_retries + 1):
            self.total_attempts += 1
            try:
                return self.fn(*args, **kw)
            except self.retryable:
                self.total_retries += 1
                if attempt == self.max_retries:
                    raise
                delay = backoff_s(attempt, base_s=self.base_delay_s, cap_s=self.max_delay_s, salt=self.jitter_salt)
                if delay > 0:
                    self.backoffs += 1
                    self.total_backoff_s += delay
                    self._sleep(delay)
        raise AssertionError("unreachable")


class ReplicaKilled(RuntimeError):
    """Raised in a replica's step loop by ``FaultInjector.kill_replica`` (a
    lost process).  The cluster takes any exception out of a replica's step
    as that replica's death; this type tells an injected kill from a real
    fault."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection for the serving engine (tests and the
    on-card smoke test), each class armed independently:

    ``nan_logits = (uid, device_step)``: poison request ``uid``'s logits to
    NaN at global decode step ``device_step`` (the engine's cumulative
    ``steps``).  The poison rides device data into the decode block, so one
    captured graph serves armed and unarmed blocks alike, and the engine's
    quarantine path runs as it would on a real numerical blow-up.

    ``deny_pages = (start, stop)``: every page reservation made during
    engine steps ``[start, stop)`` fails (pool exhaustion): admissions
    queue, deadlines expire, preemption triggers.

    ``slow_steps = (start, stop)`` with ``slow_ms``: sleep before each engine
    step in the window (a straggling device), so that wall-clock deadlines
    expire and the watchdog flags.

    Replica-level classes (the cluster's; a step index here is the
    REPLICA's local step counter, checked by ``on_replica_step``):

    ``kill_replica = (replica, local_step)``: raise :class:`ReplicaKilled`
    from that replica's step loop at exactly that step (a dead process).

    ``hang_replica = (replica, local_step)`` with ``hang_s``: block that
    replica's loop for ``hang_s`` seconds once (a wedged device): no
    exception, the heartbeat just stops.

    ``slow_replica = (replica, start, stop)`` with ``slow_ms``: sleep
    ``slow_ms`` before each of that replica's steps in ``[start, stop)``.

    ``fired`` counts what actually triggered, so a test that armed a fault
    can assert that it happened.  One injector may serve every replica
    thread: its count is locked.
    """

    nan_logits: Optional[Tuple[int, int]] = None
    deny_pages: Optional[Tuple[int, int]] = None
    slow_steps: Optional[Tuple[int, int]] = None
    slow_ms: float = 0.0
    kill_replica: Optional[Tuple[int, int]] = None
    hang_replica: Optional[Tuple[int, int]] = None
    hang_s: float = 0.5
    slow_replica: Optional[Tuple[int, int, int]] = None
    fired: Dict[str, int] = dataclasses.field(default_factory=dict)  # guarded by: _fired_lock
    _fired_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False, compare=False)

    def _hit(self, kind: str) -> None:
        with self._fired_lock:
            self.fired[kind] = self.fired.get(kind, 0) + 1

    def deny_reserve(self, step_idx: int) -> bool:
        """True when page reservations must fail at engine step ``step_idx``."""
        if self.deny_pages is None:
            return False
        a, b = self.deny_pages
        if a <= step_idx < b:
            self._hit("deny_pages")
            return True
        return False

    def on_step(self, step_idx: int) -> None:
        """Engine-step hook: applies the slow-step fault when armed."""
        if self.slow_steps is None or self.slow_ms <= 0:
            return
        a, b = self.slow_steps
        if a <= step_idx < b:
            self._hit("slow_step")
            time.sleep(self.slow_ms / 1e3)

    def on_replica_step(self, replica: int, step_idx: int) -> None:
        """Replica-step hook (the cluster's): applies the replica-level faults.
        Called by the replica thread BEFORE it steps its engine, with the
        replica id and its local step counter; raising here counts as the
        engine step raising."""
        if self.kill_replica is not None:
            rid, at = self.kill_replica
            if replica == rid and step_idx == at:
                self._hit("kill_replica")
                raise ReplicaKilled(f"injected kill: replica {rid} at step {at}")
        if self.hang_replica is not None:
            rid, at = self.hang_replica
            if replica == rid and step_idx == at:
                self._hit("hang_replica")
                time.sleep(self.hang_s)
        if self.slow_replica is not None:
            rid, a, b = self.slow_replica
            if replica == rid and a <= step_idx < b and self.slow_ms > 0:
                self._hit("slow_replica")
                time.sleep(self.slow_ms / 1e3)

    def poison_for(self, uid_of_slot: Callable[[int], Optional[int]], n_slots: int, steps_done: int,
                   block: int) -> Tuple[int, int]:
        """Resolve the NaN fault to (slot, step within the block) for the next
        decode block, or (-1, -1) when it does not land in this block."""
        if self.nan_logits is None:
            return -1, -1
        uid, at_step = self.nan_logits
        rel = at_step - steps_done
        if not 0 <= rel < block:
            return -1, -1
        for s in range(n_slots):
            if uid_of_slot(s) == uid:
                self._hit("nan_logits")
                return s, rel
        return -1, -1


def _wait_for(x) -> None:
    """Block until a device value is computed (the reference's
    ``jax.block_until_ready``): a CUDA tensor's stream is synchronized."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


@dataclasses.dataclass
class ElasticReshard:
    """Re-lay a host-restored state onto a (possibly different) mesh: each
    leaf becomes the block this rank holds under its sharding
    (``runtime.distributed.NamedSharding``), copied onto ``device``."""

    device: Optional[torch.device] = None

    def apply(self, state_host, shardings):
        def one(leaf, sh):
            block = sh.local(torch.as_tensor(leaf))
            return block.to(self.device if self.device is not None else block.device, copy=True).contiguous()

        return tree_map(one, state_host, shardings)


@dataclasses.dataclass
class TrainLoopRunner:
    """Checkpoint-restart training loop (the ``launch/train.py`` core).

    Failure contract: any exception from the step escapes (a
    :class:`RetryableStep` wrapper absorbs the transient ones first); the
    caller restores the latest checkpoint and re-enters with ``start_step``.
    The data is a pure function of the step, so the retrained batches are
    identical.  Each step's time, up to its loss being computed on the
    device, feeds the watchdog.
    """

    step_fn: Callable  # (state, batch) -> (state, metrics)
    data_at_step: Callable  # step -> host batch
    checkpointer: object
    save_every: int = 50
    watchdog: StepWatchdog = dataclasses.field(default_factory=StepWatchdog)

    def run(
        self,
        state,
        n_steps: int,
        *,
        shard_fn: Callable = lambda b: b,
        start_step: int = 0,
        on_metrics: Optional[Callable] = None,
        fail_at: Optional[Callable] = None,  # test hook: step -> bool
    ):
        step = start_step
        metrics = None
        while step < n_steps:
            t0 = time.monotonic()
            if fail_at is not None and fail_at(step):
                raise RuntimeError(f"injected failure at step {step}")
            batch = shard_fn(self.data_at_step(step))
            state, metrics = self.step_fn(state, batch)
            _wait_for(metrics["loss"])
            self.watchdog.observe(step, time.monotonic() - t0)
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            if self.checkpointer is not None and step % self.save_every == 0:
                self.checkpointer.save_async(state, step)
        if self.checkpointer is not None:
            self.checkpointer.save_async(state, step)
            self.checkpointer.wait()
        return state, metrics
