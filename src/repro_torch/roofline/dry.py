"""The dry world: the port's real programs run on fake tensors.

Inside :func:`dry_world` every tensor is a fake (``FakeTensorMode``): it has
a shape, a dtype and a storage size, and no memory behind it, so a
full-width model at a production shape is built and stepped with nothing
allocated.  The world stands in for the card:

* ``runtime/device.py::resolve_device`` gives :func:`stand_in_device` for
  ``"cuda"`` (and for no device) with no card present; outside the world it
  still raises.
* The dispatch (``runtime/dispatch.py``) takes the card's branch for every
  tensor: the kernel routing, the ``prefill=True`` plan, the torch forms of
  the dense and MLA products, the no-backward guard.  Each kernel call is
  recorded (:func:`kernel`) with its cost from ``roofline/kernel_cost.py``
  and its output computed by the kernel's plain version, uncounted; no
  kernel library is built or loaded.
* A mesh made with ``backend="dry"`` (``runtime/distributed.py``) is one
  rank of a world with no process group: its collectives return what a
  live mesh returns and record their traffic (:func:`collective`).

The fakes carry the CPU's device type.  A CPU-only build of PyTorch cannot
run autograd on a fake with the CUDA device type (the autograd engine looks
up a CUDA device guard, which such a build does not have, and aborts the
process), and the dry-run's train cells need autograd; the device type is
read by the dispatch alone, which the world overrides, so the programs run
the card's branches whatever the fakes' device type.

One dry world is active in a process at a time.  ``roofline/op_stats.py``
counts what a step runs inside it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

__all__ = ["DryWorld", "dry_world", "active", "stand_in_device", "kernel", "collective"]


class DryWorld:
    """The active world: its fake mode, and the counter of the step being
    counted (``op_stats.OpCounter``; None between counted steps)."""

    def __init__(self, mode):
        self.mode = mode
        self.counter = None


_WORLD: Optional[DryWorld] = None


@contextlib.contextmanager
def dry_world():
    """Enter the dry world (see the module docstring); yields the :class:`DryWorld`."""
    global _WORLD
    from torch._subclasses.fake_tensor import FakeTensorMode

    if _WORLD is not None:
        raise RuntimeError("a dry world is already active in this process")
    world = DryWorld(FakeTensorMode())
    with world.mode:
        _WORLD = world
        try:
            yield world
        finally:
            _WORLD = None


def active() -> bool:
    """Whether a dry world is active (the dispatch then takes the card's branches)."""
    return _WORLD is not None


def stand_in_device() -> torch.device:
    """The device the dry world's fakes carry where a program asks for the card."""
    return torch.device("cpu")


def kernel(op: str, cost: tuple, plain: Callable[[], object]):
    """One call of ``op``'s kernel in the dry world: its ``cost``, (flops,
    bytes), recorded, its output ``plain()`` (the kernel's plain version on
    the fakes, whose own ops are not counted)."""
    counter = _WORLD.counter if _WORLD is not None else None
    if counter is None:
        return plain()
    return counter.kernel(op, cost, plain)


def collective(kind: str, axis: str, n: int, moved: float) -> None:
    """One collective of a dry mesh: ``kind`` over ``axis`` (n members),
    ``moved`` ring-transfer bytes a member."""
    counter = _WORLD.counter if _WORLD is not None else None
    if counter is not None:
        counter.collective(kind, axis, n, moved)
