"""Grouped-query attention (GQA): prefill through the flash kernel, decode
through the flash-decode kernel over an in-place cache.

The port's counterpart of the GQA part of ``repro/models/attention.py``.
Both attention paths go through ``repro_torch.runtime.dispatch``.
"""

from __future__ import annotations

import torch

from repro_torch.models import modules as nn

__all__ = [
    "position_vector",
    "gqa_init",
    "gqa_forward",
    "gqa_init_cache",
    "gqa_decode",
    "decode_attention",
]


def position_vector(pos, batch: int, device) -> torch.Tensor:
    """Normalize a decode position (a scalar, or a (B,) vector for per-slot
    positions) to a (B,) int64 vector on ``device``.

    A Python scalar becomes a fill on the device, not a host-to-device copy,
    so building the vector never waits on the card."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((batch,), int(pos), dtype=torch.int64, device=device)
    pos = pos.to(device=device, dtype=torch.int64)
    return pos.expand(batch) if pos.dim() == 0 else pos.reshape(batch)


def decode_attention(q, k_cache, v_cache, n_valid):
    """One-token attention over a cache.  q: (B, 1, H, hd); caches
    (B, S, KV, *).  ``n_valid``: valid cache slots — a scalar or a (B,)
    vector; masking is strictly per sequence.  A fully-masked row produces
    zeros."""
    from repro_torch.runtime import dispatch

    B, S = q.shape[0], k_cache.shape[1]
    nv = position_vector(n_valid, B, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < nv[:, None]
    return dispatch.decode_attention(q, k_cache, v_cache, valid)


def gqa_init(generator: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": nn.dense_init(generator, d, H * hd, dtype, device),
        "wk": nn.dense_init(generator, d, KV * hd, dtype, device),
        "wv": nn.dense_init(generator, d, KV * hd, dtype, device),
        "wo": nn.dense_init(generator, H * hd, d, dtype, device, scale=(H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = nn.dense(p["wq"], x)
    k = nn.dense(p["wk"], x)
    v = nn.dense(p["wv"], x)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = nn.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = nn.apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd).contiguous()
    return q, k, v


def gqa_forward(p, x, cfg, *, positions=None, causal: bool = True, return_cache: bool = False):
    """Full-sequence GQA attention (prefill), through the flash kernel.

    Returns the output, and with ``return_cache`` also the (k, v) of every
    position for the decode cache."""
    from repro_torch.runtime import dispatch

    B, S, _ = x.shape
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window attention (ring cache) is not yet ported")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    out = dispatch.flash_attention(q, k, v, causal=causal)
    out = nn.dense(p["wo"], out.reshape(B, S, -1))
    return (out, (k, v)) if return_cache else out


def gqa_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype, device=device),
    }


def gqa_decode(p, x, cache, pos, cfg):
    """x: (B, 1, d); pos: absolute position of the new token — a scalar or a
    (B,) vector (``lm_decode_step`` passes one (B,) device vector to every
    layer).  Writes the new K/V into ``cache`` IN PLACE (the tensors may be
    views of the model's stacked (L, B, S, KV, hd) cache) and returns
    (out, cache)."""
    B = x.shape[0]
    pos_v = position_vector(pos, B, x.device)
    q, k, v = _qkv(p, x, cfg, pos_v[:, None])
    b_idx = torch.arange(B, device=x.device)
    slot = pos_v % cache["k"].shape[1]  # identity while pos < max_len, as in the reference
    cache["k"][b_idx, slot] = k[:, 0]
    cache["v"][b_idx, slot] = v[:, 0]
    out = decode_attention(q, cache["k"], cache["v"], pos_v + 1)
    return nn.dense(p["wo"], out.reshape(B, 1, -1)), cache
