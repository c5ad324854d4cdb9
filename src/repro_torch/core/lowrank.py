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
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from repro_torch.kernels._build import aligned_rows

__all__ = [
    "is_lowrank",
    "lowrank_params",
    "apply_linear",
    "param_count",
    "break_even_rank",
    "materialize",
    "slice_rank",
    "min_rank",
]


def is_lowrank(p: Any) -> bool:
    return isinstance(p, Mapping) and "a" in p and "b" in p


def lowrank_params(A: torch.Tensor, B: torch.Tensor) -> dict:
    """The factored leaf.  Factors are kept in storage whose row stride is a
    multiple of 8 elements (same shapes and values), so the CUDA kernels read
    them with 16-byte loads whatever the rank."""
    return {"a": aligned_rows(A), "b": aligned_rows(B)}


def apply_linear(p: Any, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W for dense W, or (x @ A) @ B for the factored form; the path
    is chosen by :mod:`repro_torch.runtime.dispatch`."""
    from repro_torch.runtime import dispatch

    if is_lowrank(p):
        return dispatch.lowrank_apply(x, p["a"], p["b"])
    return dispatch.dense_apply(x, p)


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
