"""Step-time watchdog and deterministic fault injection for the serving engine.

The port's own copy of the parts of ``repro/runtime/fault_tolerance.py``
that the engine uses: :class:`StepWatchdog` (straggler detection against a
rolling median of step times) and :class:`FaultInjector`'s engine-level
fault classes (``nan_logits``, ``deny_pages``, ``slow_steps``).  The
replica-level faults, the retry wrapper and the training runner belong to
the cluster and training layers, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["StepWatchdog", "FaultInjector"]


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

    ``fired`` counts what actually triggered, so a test that armed a fault
    can assert that it happened.
    """

    nan_logits: Optional[Tuple[int, int]] = None
    deny_pages: Optional[Tuple[int, int]] = None
    slow_steps: Optional[Tuple[int, int]] = None
    slow_ms: float = 0.0
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
