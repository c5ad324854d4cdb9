"""Factored (low-rank) linear parameters: W (in,out) ~= A (in,k) @ B (k,out).

The port's counterpart of ``repro/core/lowrank.py``.  A compressed linear is
represented structurally in the params tree: the dense leaf ``W`` is
replaced by ``{"a": A, "b": B}``, and every linear-apply site goes through
:func:`apply_linear`, so a compressed model is a drop-in replacement for a
dense one.

Rank tiers (:func:`slice_rank`): RSI orders the factors' directions by
decreasing singular value, so the best rank-``k`` approximation held in a
rank-``r`` pair is its prefix ``A[..., :, :k]``, ``B[..., :k, :]``.  A tier
is those prefix VIEWS of the stored factors, never copies: the stored
row-padded storage keeps A's row stride (a multiple of 8 elements) under a
column slice and B's rows contiguous under a row slice, so the kernels read
a tier in place.

Tensor parallelism (``sharding/rules.py``'s layout): :func:`apply_linear`
takes the dense leaf's spec under the active rules (``rules.leaf_spec``)
and runs the linear on this rank's blocks: an FSDP dim (over "data") is
all-gathered just before the product and dropped after it, as ZeRO-3
does; an output dim over "model" makes the linear column-parallel (no
collective after it); an input dim over "model" makes it row-parallel,
its partial products summed over "model" (or reduce-scattered onto the
sequence).  A row-parallel FACTORED linear sums its (tokens, k)
intermediate ``x_blk @ A_blk``, not the (tokens, d) output: the rank
saves that communication too.  The factor that stays whole over "model"
(A of a column-parallel leaf, B of a row-parallel one) has its gradient
psummed over "model" where each rank's is partial.  The kernels run on the blocks as they run
on whole leaves.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from repro_torch.kernels._build import aligned_rows
from repro_torch.runtime import distributed

__all__ = [
    "is_lowrank",
    "lowrank_params",
    "apply_linear",
    "param_count",
    "break_even_rank",
    "materialize",
    "slice_rank",
    "min_rank",
    "gather_blocks",
]


def is_lowrank(p: Any) -> bool:
    return isinstance(p, Mapping) and "a" in p and "b" in p


def lowrank_params(A: torch.Tensor, B: torch.Tensor) -> dict:
    """The factored leaf.  Factors are kept in storage whose row stride is a
    multiple of 8 elements (same shapes and values), so the CUDA kernels read
    them with 16-byte loads whatever the rank."""
    return {"a": aligned_rows(A), "b": aligned_rows(B)}


def gather_blocks(p: Any, spec, mesh) -> Any:
    """``p`` (dense or factored) with every dim that ``spec`` (the dense
    leaf's, one entry a dim) splits over an axis other than "model"
    all-gathered over it: the FSDP blocks made whole just before their
    product (the gather's backward sums their gradients over "data").  A
    factored leaf gathers A on the leading and input entries, B on the
    leading and output ones, each into padded-row storage."""
    def gather(w, sp):
        for dim, e in enumerate(sp):
            if e is not None and e != "model":
                w = distributed.all_gather(w, e, mesh, dim=dim)
        return w

    spec = tuple(spec)
    if is_lowrank(p):
        lead, i, o = spec[:-2], spec[-2], spec[-1]
        a, b = gather(p["a"], lead + (i, None)), gather(p["b"], lead + (None, o))
        return {"a": a if a is p["a"] else aligned_rows(a), "b": b if b is p["b"] else aligned_rows(b)}
    return gather(p, spec)


def apply_linear(p: Any, x: torch.Tensor, spec=None, *, seq_dim=None) -> torch.Tensor:
    """y = x @ W for dense W, or (x @ A) @ B for the factored form; the path
    is chosen by :mod:`repro_torch.runtime.dispatch`.

    ``spec``: the dense leaf's (input, output) entries under the active
    tensor-parallel rules (``sharding.rules.leaf_spec``; None or all None:
    the leaf is whole).  Column-parallel (output over "model"): ``x`` holds
    every input feature, the result this rank's output columns.
    Row-parallel (input over "model"): ``x`` holds this rank's input
    features, and the partial products are summed over "model" by
    ``distributed.tp_reduce``, or reduce-scattered along ``seq_dim`` where
    the sequence lies over "model"."""
    from repro_torch.runtime import dispatch

    if spec is None or all(e is None for e in spec):
        if is_lowrank(p):
            return dispatch.lowrank_apply(x, p["a"], p["b"])
        return dispatch.dense_apply(x, p)
    from repro_torch.sharding.rules import tp_rules

    mesh = tp_rules().mesh
    row, col = spec[-2] == "model", spec[-1] == "model"
    if is_lowrank(p) and (row or col):
        # the factor whole over "model" (A of a column-parallel leaf; B of a row-parallel one where its
        # rows are this rank's block of the sequence) gets rank-partial gradients: psummed over "model"
        name = "b" if row else "a"
        if not row or seq_dim is not None:
            p = {**p, name: distributed.tp_copy(p[name], "model", mesh)}
    w = gather_blocks(p, spec, mesh)

    def reduce(y):
        if seq_dim is None:
            return distributed.tp_reduce(y, "model", mesh)
        return distributed.reduce_scatter(y, "model", seq_dim, mesh)

    if is_lowrank(w):
        if row:  # the (tokens, k) intermediate is what crosses "model"
            t = reduce(dispatch.factor_apply(x, w["a"])).to(x.dtype)
            return dispatch.factor_apply(t, w["b"]).to(x.dtype)
        return dispatch.lowrank_apply(x, w["a"], w["b"])
    y = dispatch.dense_apply(x, w)
    return reduce(y) if row else y


def param_count(p: Any) -> int:
    if is_lowrank(p):
        return p["a"].numel() + p["b"].numel()
    return p.numel()


def break_even_rank(d_in: int, d_out: int) -> int:
    """Largest k for which (d_in + d_out) * k < d_in * d_out."""
    return (d_in * d_out - 1) // (d_in + d_out)


def materialize(p: Any) -> torch.Tensor:
    """Densify a (possibly factored) kernel — for analysis/tests only."""
    if is_lowrank(p):
        return torch.matmul(p["a"].float(), p["b"].float()).to(p["a"].dtype)
    return p


def _sliced_rank(r: int, fraction: float) -> int:
    return max(1, min(r, int(math.ceil(fraction * r))))


def _walk(node: Any, leaf):
    """Rebuild dicts, lists and tuples around ``leaf(factored node)``; any
    other node passes through as the same object."""
    if is_lowrank(node):
        return leaf(node)
    if isinstance(node, Mapping):
        return {key: _walk(val, leaf) for key, val in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, leaf) for v in node)
    return node


def slice_rank(params: Any, fraction: float):
    """Prefix-slice every factored leaf to ``ceil(fraction * rank)`` (at least
    1) columns of A and rows of B, as views of the same storage; stacked
    factors (layer and expert axes) slice the trailing rank axis.  Dense
    leaves pass through as the same objects, and ``fraction`` 1.0 returns
    ``params`` itself (``repro/core/lowrank.py::slice_rank``)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"rank fraction must be in (0, 1], got {fraction}")
    if fraction == 1.0:
        return params

    def leaf(node):
        k = _sliced_rank(node["a"].shape[-1], fraction)
        out = dict(node)
        out["a"] = node["a"][..., :, :k]
        out["b"] = node["b"][..., :k, :]
        return out

    return _walk(params, leaf)


def min_rank(params: Any) -> int:
    """Smallest factored rank in the tree (0 when nothing is factored)."""
    ranks: list = []

    def leaf(node):
        ranks.append(int(node["a"].shape[-1]))
        return node

    _walk(params, leaf)
    return min(ranks) if ranks else 0
