"""Shared model building blocks as plain functions on tensors.

The port's counterpart of ``repro/models/modules.py``.  Params are nested
dicts of tensors; every linear goes through
``repro_torch.core.lowrank.apply_linear`` so RSI-compressed (factored)
trees are drop-in replacements.  Products accumulate in fp32, norms and
rotary embeddings compute in fp32, results are stored in the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lowrank import apply_linear

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
]


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype, device, *,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = (d_in**-0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ W with dense or factored kernels (see core/lowrank.apply_linear)."""
    return apply_linear(p, x)


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


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


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (a gather).  Through ``F.embedding``, whose backward
    on the card sums each row's gradient in a fixed order, where the
    backward of ``table[ids]`` accumulates with atomics: a training step
    gives the same bits run after run."""
    return torch.nn.functional.embedding(ids, table)


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
