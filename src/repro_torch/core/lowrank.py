"""Factored (low-rank) linear parameters: W (in,out) ~= A (in,k) @ B (k,out).

The port's counterpart of ``repro/core/lowrank.py``.  A compressed linear is
represented structurally in the params tree: the dense leaf ``W`` is
replaced by ``{"a": A, "b": B}``, and every linear-apply site goes through
:func:`apply_linear`, so a compressed model is a drop-in replacement for a
dense one.
"""

from __future__ import annotations

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
