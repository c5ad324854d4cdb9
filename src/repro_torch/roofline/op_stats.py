"""Per-rank counts of one step in the dry world: the op counter.

The port's counterpart of ``repro/roofline/hlo_stats.py``.  The reference
walks a compiled XLA module; the port has no module to parse: eager
PyTorch runs each op once, in order, so a ``TorchDispatchMode`` over the
step sees every op the card would run, and no loop trip count is needed.
:func:`measure` runs one step inside ``roofline/dry.py::dry_world`` and
returns its :class:`OpStats`:

* ``flops``: matmul-family ops (mm, addmm, bmm, baddbmm, convolution,
  SDPA) by ``torch.utils.flop_counter``'s formulas (``matmul_flops``); the
  reference's elementwise set (``hlo_stats._EW_OPS``: add, subtract,
  multiply, divide, exponential, log, tanh, rsqrt, sqrt, power, maximum,
  minimum, compare, select) at one FLOP per output element; and each
  kernel call's FLOPs from ``roofline/kernel_cost.py``.
* ``hbm_bytes``: an eager op's operands plus its result, which is what an
  unfused op reads and writes (a view moves nothing; an in-place op counts
  its mutated operand once, as the result); a kernel call its bytes read
  once.
* ``coll_bytes`` / ``coll_by_axis`` / ``coll_ops``: the dry mesh's
  collectives, ring-transfer bytes a rank by kind and by mesh axis.
* ``peak_bytes``: the high-water mark of the live fake storages, each
  storage counted once however many views it has, freed when its last
  holder (a tensor, autograd's saved values) lets it go; the arguments
  (params, optimizer state, cache, batch) are live from the start and
  ``argument_bytes`` is their sum.  A kernel's plain version is not
  counted toward it: only the kernel's output is.
* ``kernels``: op -> {calls, flops, bytes} of the kernel calls, under the
  dispatch's op names (``runtime/dispatch.py``'s counters).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import dry

__all__ = ["OpStats", "OpCounter", "measure", "EW_OPS", "COLL_KINDS"]

# the reference's collective kinds (repro/roofline/hlo_stats.py::_COLL_KINDS)
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# the reference's elementwise set (repro/roofline/hlo_stats.py::_EW_OPS) as aten ops
EW_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "exp", "log", "tanh", "rsqrt", "sqrt", "pow", "maximum",
    "minimum", "eq", "ne", "lt", "le", "gt", "ge", "where",
})
# ops that move no bytes although their schema returns a fresh tensor: allocations, and the
# view a reshape returns
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_unsafe_view"})


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)  # kind -> bytes
    coll_ops: int = 0
    peak_bytes: int = 0
    argument_bytes: int = 0
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)  # op -> {calls, flops, bytes}
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)  # mesh axis -> bytes
    matmul_flops: float = 0.0  # the torch matmul-family ops' share of flops

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a TrainState)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._live_bytes = 0
        self._paused = 0
        self._kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self._coll = defaultdict(float)
        self._axis = defaultdict(float)

    # --- memory -------------------------------------------------------- #
    def track(self, tensors) -> int:
        """Make the storages of ``tensors`` live (each once); returns the bytes newly live."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _ref, key=key: self._free(key)), n)
            self._live_bytes += n
            added += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live_bytes)
        return added

    def _free(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self._live_bytes -= entry[1]

    # --- the ops ------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.stats.flops += f
            self.stats.matmul_flops += f
        elif name.rstrip("_") in EW_OPS:
            self.stats.flops += float(sum(t.numel() for t in outs))
        returns = func._schema.returns
        is_view = any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
        if outs and not is_view and name not in _NO_TRAFFIC:  # a query (a size, a device) moves nothing
            mutated = {id(a) for a, r in zip(args, func._schema.arguments)
                       if isinstance(a, torch.Tensor) and r.alias_info is not None and r.alias_info.is_write}
            ins = [t for t in _tensors((args, kwargs)) if id(t) not in mutated]
            self.stats.hbm_bytes += float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        if not is_view and name != "_unsafe_view":
            self.track(outs)
        return out

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def kernel(self, op: str, cost: tuple, plain: Callable[[], Any]):
        flops, nbytes = cost
        k = self._kernels[op]
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)
        self.stats.flops += float(flops)
        self.stats.hbm_bytes += float(nbytes)
        with self.paused():
            out = plain()
        self.track(_tensors(out))
        return out

    def collective(self, kind: str, axis: str, n: int, moved: float) -> None:
        self._coll[kind] += float(moved)
        self._axis[axis] += float(moved)
        self.stats.coll_ops += 1

    def result(self) -> OpStats:
        self.stats.kernels = {k: dict(v) for k, v in sorted(self._kernels.items())}
        self.stats.coll_bytes = {k: self._coll.get(k, 0.0) for k in COLL_KINDS}
        self.stats.coll_by_axis = dict(self._axis)
        return self.stats


def measure(fn: Callable[[], Any], *, arguments: Any = ()) -> Tuple[Any, OpStats]:
    """Run ``fn()`` once inside the active dry world under an :class:`OpCounter`;
    ``arguments`` (a tree of the step's inputs) are live from the start.
    Returns (fn's result, its OpStats)."""
    world = dry._WORLD
    if world is None:
        raise RuntimeError("op_stats.measure runs inside roofline.dry.dry_world()")
    counter = OpCounter()
    counter.stats.argument_bytes = counter.track(_tensors(arguments))
    world.counter = counter
    try:
        with counter:
            out = fn()
    finally:
        world.counter = None
    return out, counter.result()
