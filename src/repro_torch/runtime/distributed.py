"""Named meshes, per-rank collectives and the rank launcher.

The port's counterpart of ``repro/runtime/compat.py`` (``axis_size``,
``shard_map``, ``make_mesh``) and of the ``shard_map`` / ``psum`` idiom the
reference's multi-device layer is written in.  The reference traces one
program over a mesh of devices; the port runs one process a rank, each
holding its LOCAL blocks, and writes the communication out as
``torch.distributed`` collectives over the groups of a ``DeviceMesh`` whose
dim names are the reference's axis names (``"pod"``, ``"data"``,
``"model"``).  The compute stays in the port's own kernels and plain
PyTorch: DTensor is not used, since its ops would dispatch to library
kernels.

* :class:`MeshSpec` describes a mesh (axis names and sizes) without any
  live group, so that sharding rules and specs work anywhere; ranks lie on
  it row-major, as ``init_device_mesh`` lays them out (and as
  ``jax.make_mesh`` orders devices).  :class:`Mesh` is a live one: the
  description plus the groups, one per axis.
* A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
  tuple of names (the dim split over their product, the first name major)
  or ``None`` -- what the reference's ``PartitionSpec`` holds, so
  ``tuple(P(...))`` compares with it.  :func:`local_block` cuts the block
  a rank holds out of a global tensor; :func:`assemble` is its inverse.
* :func:`psum` / :func:`pmean` over a named axis (``None``: the identity,
  as the reference's ``_psum`` treats it), :func:`axis_index` and
  :func:`axis_size` read the active mesh (:func:`use_mesh`), as the
  reference's read the ``shard_map`` axis environment.

Gradients.  Every collective here but :func:`gather_to_first` is an
autograd Function, for two programs:

* The whole-param program (the archs outside the tensor-parallel slice:
  MLA, the SSM leaves, the vlm and the encoder-decoder): every rank holds the whole params and backpropagates its own
  loss L_r, and each collective's backward is its exact adjoint, so a
  rank's backward gives d(sum_r L_r)/d(its local values).  :func:`psum`'s
  backward is the same psum of the cotangent and :func:`shift`'s the
  reverse shift; the gradient of the mean loss G = mean_r L_r with respect
  to a value is the sum of that over the value's replicas, over the world
  size (``train_step.make_train_step(rules=)`` averages every gradient
  over the world).  :func:`psum` serves this program: the expert-parallel
  combine of the whole-param MoE layer, the pipeline, distributed RSI and
  the world-mean step.
* The tensor-parallel program (the dense and moe families under rules on
  a live mesh; each rank holds its blocks of the params,
  ``sharding/rules.py``), in Megatron's convention:
  every rank of a "data" row computes the same loss L_d and backpropagates
  it, and gets d L_d / d(its blocks).  A value replicated over "model" then
  carries either its full cotangent (the residual stream) or a
  rank-partial one (inside a tensor-parallel region, where each rank
  reaches the loss through its own columns), and the conjugate pair moves
  between the two: :func:`tp_copy` (the identity forward, a psum of the
  cotangent backward) enters a region, :func:`tp_reduce` (a psum forward,
  the identity backward) leaves it.  With the sequence over "model",
  :func:`all_gather` along the sequence (its backward a reduce-scatter of
  the cotangent) and :func:`reduce_scatter` (its backward an all-gather)
  take their places; ``all_gather(..., backward="slice")`` gathers a value
  whose consumers carry full cotangents (the router).  An all-gather over
  "data" of an FSDP block sums its gradient over the batch's ranks in the
  reduce-scatter of its backward.

Each Function keeps its group, not the thread-local mesh, since autograd
runs the backward of CUDA tensors on a thread of its own.
:func:`gather_to_first` has no backward and raises under grad where its
operand requires grad (it serves the checkpointer).

Every collective on a live mesh adds its ring-transfer bytes to a tally by
kind and by axis (:func:`collective_counts`), by the dry mesh's formulas,
so a live rank's traffic compares with its dry count.

The backend is an argument, never a fallback: ``"nccl"`` takes one rank a
card; ``"gloo"`` takes CPU ranks and ranks that share one card; ``"dry"``
(:func:`dry_mesh`) is one rank of a mesh with no process group, for the
dry-run (``roofline/dry.py``): its collectives return tensors of the shape
and dtype a live mesh returns and record one collective each (its kind,
axis, group size and ring-transfer bytes, by the reference's formulas in
``repro/roofline/hlo_stats.py``: an all-reduce moves 2(n-1)/n of its
bytes, an all-gather (n-1)/n of the gathered result, a reduce-scatter
n-1 times its scattered block, a permute all of them), backwards
included.  NCCL
refuses two ranks on one device, so a request for it with more ranks than
cards raises.  Gloo carries ``all_reduce`` and ``broadcast`` on CUDA
tensors; every other collective here stages a CUDA tensor through the host
under gloo (said at each such place).  Gloo has no reduce-scatter: there
:func:`reduce_scatter` all-reduces and keeps its block (counted as the
reduce-scatter it stands for).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import math
import os
import tempfile
import threading
from collections import Counter
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.roofline import dry
from repro_torch.runtime.device import resolve_device

__all__ = [
    "BACKENDS",
    "MeshSpec",
    "Mesh",
    "NamedSharding",
    "check_backend",
    "init",
    "make_mesh",
    "dry_mesh",
    "active_mesh",
    "use_mesh",
    "axis_names",
    "axis_index",
    "axis_size",
    "psum",
    "pmean",
    "pmax",
    "all_gather",
    "reduce_scatter",
    "tp_copy",
    "tp_reduce",
    "collective_counts",
    "reset_collective_counts",
    "gather_to_first",
    "shift",
    "shift_token",
    "join",
    "local_block",
    "assemble",
    "spawn",
]

BACKENDS = ("gloo", "nccl", "dry")

_state = threading.local()


def axis_names(entry) -> tuple:
    """The mesh axes of one spec entry: None -> (), a name -> (name,), a tuple as is."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh description: ``sizes`` over ``axes``, ranks row-major."""

    sizes: tuple
    axes: tuple

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.sizes) != len(self.axes):
            raise ValueError(f"mesh sizes {self.sizes} and axes {self.axes} differ in length")

    @property
    def shape(self) -> dict:
        """axis name -> size (the reference's ``mesh.shape``)."""
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> dict:
        """axis name -> this rank's index along it."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = {}
        for a, s in zip(reversed(self.axes), reversed(self.sizes)):
            out[a] = rank % s
            rank //= s
        return {a: out[a] for a in self.axes}

    def rank(self, coords: dict) -> int:
        """The rank at ``coords`` (:meth:`coords`' inverse)."""
        r = 0
        for a, s in zip(self.axes, self.sizes):
            r = r * s + coords[a]
        return r

    def index(self, entry, coords: dict) -> tuple:
        """(index, count) of a spec entry's block at ``coords``."""
        idx, n = 0, 1
        for a in axis_names(entry):
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in the mesh {self.shape}")
            idx = idx * self.shape[a] + coords[a]
            n *= self.shape[a]
        return idx, n


class _DryGroup:
    """One axis of a dry mesh, where a live mesh has its process group."""

    def __init__(self, axis: str, size: int):
        self.axis, self.size = axis, size

    def record(self, kind: str, moved: float) -> None:
        dry.collective(kind, self.axis, self.size, moved)


class _LiveGroup:
    """One axis of a live mesh: its process group, name and size."""

    def __init__(self, pg, axis: str, size: int):
        self.pg, self.axis, self.size = pg, axis, size

    def record(self, kind: str, moved: float) -> None:
        with _TALLY_LOCK:
            _TALLY[("kind", kind)] += float(moved)
            _TALLY[("axis", self.axis)] += float(moved)
            _TALLY[("ops", "")] += 1


_TALLY_LOCK = threading.Lock()
_TALLY: Counter = Counter()  # guarded by: _TALLY_LOCK -- live collectives' bytes by kind and axis


def collective_counts() -> dict:
    """The live collectives since :func:`reset_collective_counts`, as a dry
    count reports them: ``{"by_kind": ..., "by_axis": ..., "ops": n}``
    (ring-transfer bytes a rank)."""
    with _TALLY_LOCK:
        t = dict(_TALLY)
    return {"by_kind": {k: v for (w, k), v in t.items() if w == "kind"},
            "by_axis": {k: v for (w, k), v in t.items() if w == "axis"},
            "ops": int(t.get(("ops", ""), 0))}


def reset_collective_counts() -> None:
    with _TALLY_LOCK:
        _TALLY.clear()


class Mesh:
    """A live mesh: its :class:`MeshSpec` and one process group an axis
    (a ``torch.distributed.device_mesh.DeviceMesh``); or, with backend
    ``"dry"``, one given rank of a mesh with no process group."""

    def __init__(self, spec: MeshSpec, device_mesh, *, backend: str, device: torch.device,
                 rank: Optional[int] = None):
        self.spec = spec
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = device
        self.rank = dist.get_rank() if rank is None else rank
        self.coords = spec.coords(self.rank)

    @property
    def shape(self) -> dict:
        return self.spec.shape

    @property
    def axes(self) -> tuple:
        return self.spec.axes

    def group(self, axis: str):
        """The axis's group: a process group wrapped with its name and size
        (a dry mesh: the stand-in that records instead)."""
        if self.backend == "dry":
            return _DryGroup(axis, self.shape[axis])
        return _LiveGroup(self.device_mesh.get_group(axis), axis, self.shape[axis])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend}, rank={self.rank})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``), seen from one
    rank: :meth:`local` cuts that rank's block (``rank`` None: this
    process's rank in the default group, 0 without one)."""

    mesh: Union[MeshSpec, Mesh]
    spec: tuple
    rank: Optional[int] = None

    def local(self, x):
        rank = self.rank
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        return local_block(x, self.spec, self.mesh, rank)


def _spec_of(mesh) -> MeshSpec:
    return mesh.spec if isinstance(mesh, Mesh) else mesh


def local_block(x, spec: Sequence, mesh, rank: Union[int, dict]):
    """The block of the global ``x`` (tensor or array) that ``rank`` (or
    coordinates) holds under ``spec`` on ``mesh``: a view, no copy."""
    ms = _spec_of(mesh)
    coords = ms.coords(rank) if isinstance(rank, int) else rank
    spec = tuple(spec)
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} longer than the rank-{x.ndim} value")
    for dim, entry in enumerate(spec):
        idx, n = ms.index(entry, coords)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axis_names(entry)} ({n})")
        c = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(idx * c, (idx + 1) * c),)]
    return x


def assemble(blocks: Sequence[torch.Tensor], spec: Sequence, mesh) -> torch.Tensor:
    """The global tensor from every rank's block (``blocks[r]`` rank r's),
    :func:`local_block`'s inverse; replicated ranks hold equal blocks."""
    ms = _spec_of(mesh)
    spec = tuple(spec) + (None,) * (blocks[0].ndim - len(spec))
    counts = [ms.index(e, ms.coords(0))[1] for e in spec]
    shape = tuple(s * n for s, n in zip(blocks[0].shape, counts))
    out = torch.empty(shape, dtype=blocks[0].dtype, device=blocks[0].device)
    for r, b in enumerate(blocks):
        coords = ms.coords(r)
        sl = []
        for dim, e in enumerate(spec):
            idx, _ = ms.index(e, coords)
            c = b.shape[dim]
            sl.append(slice(idx * c, (idx + 1) * c))
        out[tuple(sl)] = b
    return out


def check_backend(backend: str, world: int, device: Union[str, torch.device]) -> None:
    """Raise unless ``backend`` can carry ``world`` ranks on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "dry":
        raise ValueError("a dry mesh has no process group and no processes: make one rank of it with dry_mesh")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl carries CUDA tensors only: ranks on the CPU take backend='gloo'")
        n = torch.cuda.device_count()
        if world > n or (dev.index is not None and world > 1):
            raise RuntimeError(
                f"nccl takes one rank per card and refuses two ranks on one device: {world} ranks, "
                f"{n} card(s){'' if dev.index is None else f', all on {dev}'}; ranks that share a card "
                "take backend='gloo'")


def _mesh_device_type(backend: str) -> str:
    # the groups' backend is the default group's: a gloo mesh is laid out as a CPU mesh (its
    # all_reduce still carries CUDA tensors), an nccl one as a CUDA mesh
    return "cuda" if backend == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """Another live mesh over the initialized world (every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh

    cur = active_mesh()
    backend = dist.get_backend()
    spec = MeshSpec(tuple(shape), tuple(axes))
    if spec.size != dist.get_world_size():
        raise ValueError(f"mesh {spec.shape} needs {spec.size} ranks, the world has {dist.get_world_size()}")
    dm = init_device_mesh(_mesh_device_type(backend), spec.sizes, mesh_dim_names=spec.axes)
    device = cur.device if cur is not None else torch.device("cpu")
    return Mesh(spec, dm, backend=backend, device=device)


def dry_mesh(spec: MeshSpec, rank: int = 0, device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """Rank ``rank`` of a mesh ``spec`` with no process group (backend
    ``"dry"``), on ``device`` (default the card): what the dry-run runs one
    rank of a production mesh on."""
    return Mesh(spec, None, backend="dry", device=resolve_device(device), rank=rank)


def init(shape: Sequence[int], axes: Sequence[str], *, backend: str, rank: int, world: int, init_file: str,
         device: Union[str, torch.device], timeout_s: float = 600.0) -> Mesh:
    """Join the process group (a file store at ``init_file``) as ``rank`` of
    ``world`` and make the mesh ``shape`` over ``axes`` the active one."""
    dev = torch.device(device)
    check_backend(backend, world, torch.device(dev.type) if backend == "nccl" else dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **({"device_id": dev} if backend == "nccl" else {}))
    mesh = make_mesh(shape, axes)
    mesh.device = dev
    _state.mesh = mesh
    return mesh


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    m = mesh if mesh is not None else active_mesh()
    if not isinstance(m, Mesh):
        raise RuntimeError("no live mesh: call distributed.init (or spawn) first, or pass one")
    return m


def axis_size(axis, mesh: Optional[Mesh] = None) -> int:
    """Ranks along ``axis`` (a name, a tuple of names, or None: 1)."""
    names = axis_names(axis)
    if not names:
        return 1
    m = _mesh(mesh)
    return math.prod(m.shape[a] for a in names)


def axis_index(axis, mesh: Optional[Mesh] = None) -> int:
    """This rank's index along ``axis`` (a tuple of names: the first major)."""
    names = axis_names(axis)
    if not names:
        return 0
    m = _mesh(mesh)
    return m.spec.index(names, m.coords)[0]


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """Reduce ``t`` in place over ``group`` (a dry group only records it)."""
    n = group.size
    group.record("all-reduce", 2.0 * (n - 1) / n * t.numel() * t.element_size())
    if isinstance(group, _LiveGroup):
        dist.all_reduce(t, op=op, group=group.pg)


class _PSum(torch.autograd.Function):
    """The all-reduce sum over ``group``; its backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        _all_reduce(out, ctx.group)
        return out, None


def psum(x: torch.Tensor, axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axis`` (None: ``x`` itself); a
    tuple of names sums over each in turn.  Every member gets the same bits.
    Its backward is the same psum of the cotangent."""
    for a in axis_names(axis):
        m = _mesh(mesh)
        if m.shape[a] == 1:
            continue
        x = _PSum.apply(x, m.group(a))
    return x


def pmean(x: torch.Tensor, axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean of ``x`` over the ranks along ``axis``, one name at a time."""
    for a in axis_names(axis):
        n = axis_size(a, mesh)
        if n > 1:
            x = psum(x, a, mesh) / n
    return x


def _check_no_backward(op: str, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{op} has no backward, and its operand requires grad; "
                           "run it under torch.no_grad()")


def _gather_parts(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in index order (a dry
    group records it and returns the shape)."""
    n = group.size
    shape = list(x.shape)
    shape[dim] *= n
    group.record("all-gather", (n - 1) / n * math.prod(shape) * x.element_size())
    if isinstance(group, _DryGroup):
        return x.new_empty(shape)
    # gloo gathers only CPU tensors: a CUDA tensor goes through the host
    staged = dist.get_backend(group.pg) == "gloo" and x.device.type == "cuda"
    src = x.detach().cpu().contiguous() if staged else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim=dim).to(x.device)


def _scatter_sum(x: torch.Tensor, group, dim: int, idx: int) -> torch.Tensor:
    """The sum over the members of ``x``, this member's ``idx``-th block
    along ``dim`` of it (a dry group records it and returns the shape)."""
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide over {n}")
    c = x.shape[dim] // n
    shape = list(x.shape)
    shape[dim] = c
    group.record("reduce-scatter", (n - 1.0) * math.prod(shape) * x.element_size())
    if isinstance(group, _DryGroup):
        return x.new_empty(shape)
    if dist.get_backend(group.pg) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((c,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group.pg)
        return out.movedim(0, dim).contiguous()
    # gloo has no reduce-scatter: the all-reduce, then this member's block
    full = x.detach().contiguous().clone()
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group.pg)
    return full.narrow(dim, idx * c, c).contiguous()


class _AllGather(torch.autograd.Function):
    """The members' blocks concatenated along ``dim``.  Backward
    ``"reduce_scatter"``: the sum of the members' cotangents, this member's
    block of it (the cotangents are rank-partial); ``"slice"``: this
    member's block of its own cotangent (they are full)."""

    @staticmethod
    def forward(ctx, x, group, dim: int, idx: int, backward: str):
        ctx.meta = (group, dim, idx, backward, x.shape[dim])
        return _gather_parts(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, idx, backward, c = ctx.meta
        if backward == "slice":
            return g.narrow(dim, idx * c, c).contiguous(), None, None, None, None
        return _scatter_sum(g, group, dim, idx), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The members' sum, this member's block along ``dim``; the backward
    all-gathers the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim: int, idx: int):
        ctx.meta = (group, dim)
        return _scatter_sum(x, group, dim, idx)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.meta
        return _gather_parts(g.contiguous(), group, dim), None, None, None


class _Copy(torch.autograd.Function):
    """The identity forward, a psum of the cotangent backward (Megatron's
    entry into a tensor-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        _all_reduce(out, ctx.group)
        return out, None


class _Reduce(torch.autograd.Function):
    """A psum forward, the identity backward (Megatron's exit from a
    tensor-parallel region: the cotangent arrives full on every member)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _axis(axis, mesh: Optional[Mesh]):
    """(mesh, the one axis name, its size) of a one-axis argument."""
    m = _mesh(mesh)
    (a,) = axis_names(axis)
    return m, a, m.shape[a]


def all_gather(x: torch.Tensor, axis, mesh: Optional[Mesh] = None, *, dim: Optional[int] = None,
               backward: str = "reduce_scatter") -> torch.Tensor:
    """Every member's ``x`` along one named axis, in index order: stacked,
    (n, *x.shape), or with ``dim`` concatenated along that dim.  Its
    backward (``backward``): ``"reduce_scatter"`` sums the members'
    cotangents and keeps this member's block (the gathered value's
    consumers reach the loss through rank-partial paths); ``"slice"`` keeps
    this member's block of its own cotangent (they carry full ones)."""
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"all_gather backward {backward!r}")
    m, a, n = _axis(axis, mesh)
    if dim is None:
        return all_gather(x[None], a, m, dim=0, backward=backward)
    if n == 1:
        return x
    return _AllGather.apply(x, m.group(a), dim % x.dim(), m.coords[a], backward)


def reduce_scatter(x: torch.Tensor, axis, dim: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the members of one named axis, this member's
    block of it along ``dim`` (n-way); its backward all-gathers."""
    m, a, n = _axis(axis, mesh)
    if n == 1:
        return x
    return _ReduceScatter.apply(x, m.group(a), dim % x.dim(), m.coords[a])


def tp_copy(x: torch.Tensor, axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` itself; the backward psums the cotangent over ``axis`` (None: the identity)."""
    for a in axis_names(axis):
        m = _mesh(mesh)
        if m.shape[a] > 1:
            x = _Copy.apply(x, m.group(a))
    return x


def tp_reduce(x: torch.Tensor, axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The psum of ``x`` over ``axis``; the backward passes the cotangent on."""
    for a in axis_names(axis):
        m = _mesh(mesh)
        if m.shape[a] > 1:
            x = _Reduce.apply(x, m.group(a))
    return x


@torch.no_grad()
def pmax(x: torch.Tensor, axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (no backward: it serves
    the log-sum-exp's shift, which the result does not depend on)."""
    x = x.detach().contiguous().clone()
    for a in axis_names(axis):
        m = _mesh(mesh)
        if m.shape[a] > 1:
            _all_reduce(x, m.group(a), dist.ReduceOp.MAX)
    return x


def gather_to_first(x: torch.Tensor, mesh: Optional[Mesh] = None) -> Optional[list]:
    """Every rank's ``x`` (index r: rank r's) on rank 0, on the host; None elsewhere."""
    _check_no_backward("gather_to_first", x)
    m = _mesh(mesh)
    # gloo gathers only CPU tensors, and the caller wants the host anyway; nccl gathers on the card
    src = x.detach().cpu().contiguous() if m.backend == "gloo" else x.detach().contiguous()
    world = m.spec.size
    parts = [torch.empty_like(src) for _ in range(world)] if m.rank == 0 else None
    # a gather to one rank, priced as the all-gather over the world
    cls = _DryGroup if m.backend == "dry" else functools.partial(_LiveGroup, None)
    cls(",".join(m.axes), world).record("all-gather", (world - 1) * src.numel() * src.element_size())
    if m.backend != "dry":
        dist.gather(src, parts, dst=0)
    return None if parts is None else [p.cpu() for p in parts]


def _exchange(out: Optional[torch.Tensor], dst: Optional[int], like: Optional[tuple], src: Optional[int],
              group, staged: bool) -> Optional[torch.Tensor]:
    """Send ``out`` to global rank ``dst`` and receive a tensor ``like``
    (shape, dtype, device) from ``src``, either of them None for none."""
    if dst is not None:
        group.record("collective-permute", float(out.numel() * out.element_size()))
    if isinstance(group, _DryGroup):  # the send is recorded, the receive an empty buffer
        return None if src is None else torch.empty(like[0], dtype=like[1], device=like[2])
    work = None
    if dst is not None:
        # gloo sends only CPU tensors: a CUDA tensor goes through the host
        out = out.cpu().contiguous() if staged else out.contiguous()
        work = dist.isend(out, dst=dst, group=group.pg)
    got = None
    if src is not None:
        shape, dtype, device = like
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        dist.recv(buf, src=src, group=group.pg)
        got = buf.to(device)
    if work is not None:
        work.wait()
    return got


class _Shift(torch.autograd.Function):
    """One pipeline step: (token, y) -> (received, token).  The backward is
    the reverse step: the cotangent of what was received goes back to the
    rank it came from, and y's cotangent comes from the rank y went to.
    The token orders the steps' backwards on every rank (each step's
    backward runs after the next one's), so the two sides' sends and
    receives pair up, and it carries the backward to a step whose sent
    value reaches no loss on this rank."""

    @staticmethod
    def forward(ctx, token, y, group, nxt, prev, like, staged):
        ctx.meta = (group, nxt, prev, staged, None if y is None else (y.shape, y.dtype, y.device))
        got = _exchange(y, nxt, like, prev, group, staged)
        return (token.new_zeros(0) if got is None else got), token.clone()

    @staticmethod
    def backward(ctx, g_got, g_token):
        group, nxt, prev, staged, y_like = ctx.meta
        g_y = _exchange(g_got if prev is not None else None, prev, y_like, nxt, group, staged)
        return g_token, g_y, None, None, None, None, None


class _Join(torch.autograd.Function):
    """``x`` itself, made to depend on ``token``: the backward passes x's
    cotangent on and a zero to the token, so a rank's backward reaches
    every pipeline step (and the psum after it) whatever x depends on."""

    @staticmethod
    def forward(ctx, x, token):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


def shift_token(device, needs_grad: bool) -> torch.Tensor:
    """The first token of a chain of :func:`shift` calls (a 0-d fp32 zero,
    requiring grad where the chain's backward should run)."""
    return torch.zeros((), dtype=torch.float32, device=device, requires_grad=needs_grad and torch.is_grad_enabled())


def join(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``x`` (a copy, the same bits) with the last token of a chain of
    :func:`shift` calls attached; see :class:`_Join`."""
    return _Join.apply(x, token) if token.requires_grad else x


def shift(y: Optional[torch.Tensor], axis: str, *, send: bool, recv_like: Optional[torch.Tensor],
          token: torch.Tensor, mesh: Optional[Mesh] = None) -> tuple:
    """One step of a pipeline along ``axis``: send ``y`` to index + 1 (when
    ``send``) and receive from index - 1 a tensor shaped like ``recv_like``
    (when it is given).  Returns (what was received or None, the next
    token); :func:`join` the last token into the chain's output."""
    m = _mesh(mesh)
    g = m.group(axis)
    i = m.coords[axis]
    staged = m.backend == "gloo" and ((y is not None and y.device.type == "cuda")
                                      or (recv_like is not None and recv_like.device.type == "cuda"))
    if m.backend == "dry":
        nxt = m.spec.rank({**m.coords, axis: i + 1}) if send else None
        prev = m.spec.rank({**m.coords, axis: i - 1}) if recv_like is not None else None
    else:
        nxt = dist.get_global_rank(g.pg, i + 1) if send else None
        prev = dist.get_global_rank(g.pg, i - 1) if recv_like is not None else None
    like = None if recv_like is None else (recv_like.shape, recv_like.dtype, recv_like.device)
    got, token = _Shift.apply(token, y if send else None, g, nxt, prev, like, staged)
    return (got if prev is not None else None), token


def _rank_main(rank: int, fn: Callable, world: int, shape: tuple, axes: tuple, device: str, backend: str,
               tmp: str, timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}") if backend == "nccl" else torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # gloo ranks sharing "the card": device 0
        dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = init(shape, axes, backend=backend, rank=rank, world=world, init_file=os.path.join(tmp, "store"),
                device=dev, timeout_s=timeout_s)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, shape: Sequence[int], axes: Sequence[str],
          device: Optional[Union[str, torch.device]], *args, backend: str = "gloo",
          timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` new processes, one a rank, over a
    mesh ``shape`` x ``axes``; returns each rank's return value (rank order,
    loaded onto the CPU).

    ``device``: the ranks' device, the card by default (``"cpu"`` for CPU
    ranks; under gloo every rank shares it; under nccl rank r takes
    ``cuda:r``).  Each rank runs on one intra-op thread.  ``fn`` and
    ``args`` cross by pickling (``torch.multiprocessing``: CUDA tensors as
    IPC handles into this process's memory, which outlives the ranks, CPU
    tensors through shared memory).  Pass tensors, not large numpy arrays:
    those are pickled by value into each rank's start pipe, one rank after
    the other (1.5 MB of arrays took eight CPU ranks 18 s longer to start).
    The kernels a rank launches should be built first
    (``kernels._build.build_all``), or the ranks race to build them.
    """
    dev = resolve_device(device)
    check_backend(backend, world, dev)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} does not hold {world} ranks")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, world, tuple(shape), tuple(axes), str(dev), backend, tmp,
                                                      timeout_s, args), nprocs=world, join=True)
        if dev.type == "cuda":
            torch.cuda.ipc_collect()  # release what the ranks held of this process's CUDA tensors
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(world)]
