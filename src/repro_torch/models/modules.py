"""Shared model building blocks as plain functions on tensors.

The port's counterpart of ``repro/models/modules.py``.  Params are nested
dicts of tensors; every linear goes through
``repro_torch.core.lowrank.apply_linear`` so RSI-compressed (factored)
trees are drop-in replacements.  Products accumulate in fp32, norms and
rotary embeddings compute in fp32, results are stored in the input dtype.

Under tensor-parallel rules (``sharding/rules.py``) a forward carries a
:class:`TensorParallel`: the mesh, this rank's index along "model" and
whether the residual stream's sequence lies over "model" between blocks
(``"seq"`` mapped and the sequence divisible).  Its methods are the
moves between the residual stream's layout and a tensor-parallel
region's; :func:`embed_lookup` is vocab-parallel under it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.lowrank import apply_linear, gather_blocks
from repro_torch.runtime import distributed
from repro_torch.sharding.rules import leaf_spec, tp_rules

__all__ = [
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "embed_init",
    "embed_lookup",
    "rope_freqs",
    "apply_rope",
    "sinusoidal_positions",
    "swiglu",
    "gelu",
    "TensorParallel",
    "tensor_parallel",
    "tp_linear",
]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One forward's tensor-parallel layout (the module docstring)."""

    mesh: Any
    size: int  # ranks along "model"
    index: int  # this rank's index along it
    sp: bool  # the residual stream's sequence (dim 1) over "model" between blocks

    @property
    def seq_dim(self) -> Optional[int]:
        """The dim a row-parallel linear reduce-scatters onto (None: it psums)."""
        return 1 if self.sp else None

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The residual stream's rows, whole and replicated over "model",
        entering a tensor-parallel region (rank-partial cotangents): the
        gather of the sequence (its backward a reduce-scatter), else the
        identity with a psum backward."""
        if self.sp:
            return distributed.all_gather(h, "model", self.mesh, dim=1)
        return distributed.tp_copy(h, "model", self.mesh)

    def whole(self, h: torch.Tensor) -> torch.Tensor:
        """The residual stream's rows, whole, for consumers that carry full
        cotangents on every rank (the router, the head's input rows)."""
        return distributed.all_gather(h, "model", self.mesh, dim=1, backward="slice") if self.sp else h

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Rank-partial sums leaving a region into the residual stream."""
        if self.sp:
            return distributed.reduce_scatter(y, "model", 1, self.mesh)
        return distributed.tp_reduce(y, "model", self.mesh)

    def copy(self, v):
        """A value every rank holds whole (a tensor, or a factored leaf's
        ``{"a", "b"}``), entering a region: the identity, its cotangent
        (rank-partial inside) psummed over "model"."""
        if isinstance(v, dict):
            return {k: self.copy(t) for k, t in v.items()}
        return distributed.tp_copy(v, "model", self.mesh)

    def exit_whole(self, y: torch.Tensor) -> torch.Tensor:
        """A value every rank computed whole (through a leaf the rules keep
        whole over "model") leaving a region into the residual stream: this
        rank's rows where the sequence lies over "model", else the value
        itself.  Either way the cotangent it passes back is rank-partial, as
        the region's entry expects: this rank's rows, or the whole cotangent
        on index 0 of "model" and zeros elsewhere."""
        if self.sp:
            n = y.shape[1] // self.size
            return y[:, self.index * n:(self.index + 1) * n]
        return _FirstOnly.apply(y, self.index == 0)

    def replicated(self, w: torch.Tensor) -> torch.Tensor:
        """A param replicated over "model" used on this rank's rows of the
        sequence: its gradient psummed over "model" (the identity without
        the sequence split, where every rank sees every row)."""
        return distributed.tp_copy(w, "model", self.mesh) if self.sp else w

    def gather_features(self, y: torch.Tensor) -> torch.Tensor:
        """A column-parallel output's blocks of features (last dim) made
        whole (the backward keeps this rank's block of the summed
        cotangents)."""
        return distributed.all_gather(y, "model", self.mesh, dim=-1)

    def own_features(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim of a value replicated over "model"."""
        c = y.shape[-1] // self.size
        return y[..., self.index * c:(self.index + 1) * c]


class _FirstOnly(torch.autograd.Function):
    """The identity; the backward keeps the cotangent where ``first``, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, first: bool):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def tensor_parallel(seq_len: Optional[int] = None) -> Optional[TensorParallel]:
    """The active forward's :class:`TensorParallel` (None outside
    tensor-parallel rules); ``seq_len`` the GLOBAL sequence length of a
    training or prefill forward (None: decode, the sequence never split)."""
    rules = tp_rules()
    if rules is None:
        return None
    mesh = rules.mesh
    m = mesh.shape.get("model", 1)
    sp = seq_len is not None and m > 1 and rules.resolve("seq", seq_len) == "model"
    return TensorParallel(mesh, m, distributed.axis_index("model", mesh) if m > 1 else 0, sp)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype, device, *,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = (d_in**-0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _check_vocab(name: str, shape: tuple, spec: tuple, dim: int) -> None:
    """Raise unless the vocab (dim ``dim`` of ``name``) splits over "model":
    the program has no fallback for it (``sharding/rules.py``;
    ``vocab_padded`` is a multiple of 256)."""
    if spec[dim] != "model":
        raise ValueError(f"the tensor-parallel program needs the vocab of {name} {tuple(shape)} to divide over "
                         "\"model\"")


def tp_linear(tp: Optional[TensorParallel], p, x: torch.Tensor, name: str, shape: tuple, *,
              row: bool = False) -> torch.Tensor:
    """The linear ``name`` (its path under a layer, its GLOBAL dense shape
    (d_in, d_out)) inside a tensor-parallel region: column-parallel, or
    with ``row`` the region's exit (row-parallel: the partial sums leave
    into the residual stream's layout).  Where the rules keep the leaf
    whole over "model" (its split dim does not divide, the reference's
    fallback) every rank computes the whole product: ``x`` then holds every
    feature, a column linear returns every output column, and a row linear
    leaves through :meth:`TensorParallel.exit_whole`.  Without ``tp``: the
    plain linear."""
    if tp is None:
        return apply_linear(p, x)
    spec = leaf_spec(name, shape)
    if spec[0 if row else 1] != "model":
        y = apply_linear(tp.copy(p), x, spec)  # the cotangents reaching it are rank-partial
        return tp.exit_whole(y) if row else y
    return apply_linear(p, x, spec, seq_dim=tp.seq_dim if row else None)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ W with dense or factored kernels (see core/lowrank.apply_linear)."""
    return apply_linear(p, x)


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Over the last dim, in fp32; under ``tp`` on this rank's rows (the
    scale's gradient psummed over "model" where the rows are split)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = p["scale"] if tp is None else tp.replicated(p["scale"])
    return (y * scale.float()).to(x.dtype)


def layernorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and population variance in fp32 (``jnp.var``'s ddof 0)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32, device=device)
    return (w * (d**-0.5)).to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, tp: Optional[TensorParallel] = None,
                 shape: Optional[tuple] = None) -> torch.Tensor:
    """Rows of ``table`` (a gather).  Through ``F.embedding``, whose backward
    on the card sums each row's gradient in a fixed order, where the
    backward of ``table[ids]`` accumulates with atomics: a training step
    gives the same bits run after run.

    Under ``tp`` the lookup is vocab-parallel: the table's ``d`` block is
    gathered over "data", ids outside this rank's vocab block give zero
    rows, and the ranks' rows are summed over "model" (reduce-scattered
    onto the sequence where it lies over "model"); ``shape`` is the whole
    table's (vocab, d)."""
    if tp is None:
        return torch.nn.functional.embedding(ids, table)
    spec = leaf_spec("embed", shape)
    _check_vocab("embed", shape, spec, 0)
    w = gather_blocks(table, spec, tp.mesh)
    lo, n = tp.index * w.shape[0], w.shape[0]
    mine = (ids >= lo) & (ids < lo + n)
    rows = torch.nn.functional.embedding(torch.where(mine, ids - lo, torch.zeros_like(ids)), w)
    return tp.exit(rows * mine[..., None].to(rows.dtype))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half of head_dim pairs)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: (..., seq, heads, head_dim); positions
    (..., seq) integer."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * inv  # (..., S, hd/2)
    sin = torch.sin(ang)[..., :, None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32 sinusoidal position table: sines in the first half of the
    columns, cosines in the second."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)  # a scalar base: no host-to-device copy (graph capture)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in fp32, stored in x's dtype: the tanh form, ``jax.nn.gelu``'s
    default (``approximate=True``), not torch's exact default."""
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)
