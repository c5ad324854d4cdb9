"""Grouped-query attention (GQA): prefill through the flash kernel, decode
through the flash-decode kernel over an in-place cache — flat, or a pool of
pages behind a block table — and page-backed prefill chunks.

The port's counterpart of the GQA part of ``repro/models/attention.py``.
The attention kernels go through ``repro_torch.runtime.dispatch``.  Where
the reference returns updated caches, the port writes the cache tensors
IN PLACE and returns the same tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF, gather_pages
from repro_torch.models import modules as nn

__all__ = [
    "position_vector",
    "gqa_init",
    "gqa_forward",
    "gqa_init_cache",
    "gqa_decode",
    "decode_attention",
    "paged_decode_attention",
    "trash_page",
    "gqa_init_cache_paged",
    "gqa_decode_paged",
    "gqa_prefill_chunk",
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


# --------------------------------------------------------------------------- #
# Paged GQA (block-table KV pool; continuous-batching serving)
# --------------------------------------------------------------------------- #
def paged_decode_attention(q, k_pool, v_pool, block_table, n_valid):
    """One-token attention through a paged KV pool (block-table indirection).

    q: (B, 1, H, hd); pools: (P, page, KV, *) physical pages shared by every
    slot (the LAST page is the trash page, see :func:`trash_page`);
    block_table: (B, n_tbl) int32; ``n_valid``: scalar or (B,) count of
    valid logical positions.  Masking is strict per slot, as in
    :func:`decode_attention`."""
    from repro_torch.runtime import dispatch

    nv = position_vector(n_valid, q.shape[0], q.device).to(torch.int32)
    return dispatch.paged_decode_attention(q, k_pool, v_pool, block_table, nv)


def trash_page(pool) -> int:
    """Physical id of a pool's write-off page (ALWAYS the last one).

    A pool carries ``n_pages`` allocatable pages plus one trailing trash
    page: inactive/frozen slots and padded prefill rows write there, and
    block-table entries beyond a slot's allocation point there.  Its
    contents are never attended: every read masks by ``n_valid`` first."""
    return pool.shape[0] - 1


def _paged_write(pool, block_table, pos_v, rows, *, live=None):
    """Scatter token rows into their pages, in place: logical position
    ``pos`` lives at ``pool[table[pos // page], pos % page]``.

    ``block_table`` is (B, n_tbl) with one position per slot (a decode
    step: row b writes through table row b), or ONE table row (n_tbl,) with
    many positions (a prefill chunk writing one slot's pages).  ``live``
    (optional bool mask over positions) routes dead rows to the trash page.
    Several rows may land on the trash page at once (frozen or empty
    slots); which one wins does not matter, since trash is never read."""
    page = pool.shape[1]
    idx = torch.clamp(pos_v // page, 0, block_table.shape[-1] - 1)
    if block_table.dim() == 2:
        ids = block_table[torch.arange(pos_v.shape[0], device=pos_v.device), idx]
    else:
        ids = block_table[idx]
    ids = ids.long()
    if live is not None:
        ids = torch.where(live, ids, torch.full_like(ids, trash_page(pool)))
    pool[ids, pos_v % page] = rows
    return pool


def gqa_init_cache_paged(cfg, page_size: int, n_pages_phys: int, dtype, device):
    """Physical page pools replacing the per-slot (B, S) reservation.

    Returns ``(cache, paged)``.  Zeros, never uninitialized memory: a
    masked p of 0 times a NaN left in V would still be NaN."""
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window attention (ring cache) is not yet ported")
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_pages_phys, page_size, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_pages_phys, page_size, KV, hd), dtype=dtype, device=device),
    }, True


def gqa_decode_paged(p, x, cache, pos, cfg, block_table):
    """Paged twin of :func:`gqa_decode`: the new token's K/V is written into
    the slot's current page (in place) and attention walks the block table.
    Computes what :func:`gqa_decode` computes on the flat layout."""
    B = x.shape[0]
    pos_v = position_vector(pos, B, x.device)
    q, k, v = _qkv(p, x, cfg, pos_v[:, None])
    _paged_write(cache["k"], block_table, pos_v, k[:, 0])
    _paged_write(cache["v"], block_table, pos_v, v[:, 0])
    out = paged_decode_attention(q, cache["k"], cache["v"], block_table, pos_v + 1)
    return nn.dense(p["wo"], out.reshape(B, 1, -1)), cache


def _chunk_masked_attention(q, k, v, q_pos):
    """Causal attention of a prefill CHUNK against a gathered cache view.

    q: (B, C, H, hd) chunk queries at absolute positions ``q_pos`` (B, C);
    k/v: (B, S, KV, *) the slot's gathered logical cache (chunk K/V already
    written); query i attends exactly the positions j <= q_pos[i].

    A plain PyTorch function (an einsum in the reference too).  Its numerics
    MIRROR the single-block prefill path (``ref.chunked_attention_ref``):
    q scaled in fp32 and rounded back, the same contractions, p rounded to
    the cache dtype BEFORE the V product, the denominator divided out
    AFTER.  Masked columns are exact zeros, so a chunked prefill is
    bit-identical to the monolithic one on the CPU path.
    """
    B, C, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = (q.float() * hd**-0.5).to(q.dtype).reshape(B, C, KV, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qs.float(), k.float())  # (B, KV, G, C, S) fp32
    mask = torch.arange(S, device=q.device)[None, None, :] <= q_pos[:, :, None]  # (B, C, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)  # masked columns underflow to exactly 0
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqc,bckv->bkgqv", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, C, vd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, v.shape[-1]).to(q.dtype)


def gqa_prefill_chunk(p, x, cache, cfg, bt_row, start: int, n_real: int):
    """One page-backed prefill chunk for a SINGLE slot (B == 1).

    x: (1, C, d) normed chunk activations at absolute positions
    ``start + [0, C)``; ``bt_row``: the slot's (n_tbl,) block-table row;
    ``n_real``: how many leading tokens are real (a prompt's last chunk is
    right-padded; padded rows write to the trash page).  Writes the chunk's
    K/V into the slot's pages FIRST, then attends over the gathered logical
    cache, so causality within the chunk and attention to every earlier
    chunk come from one absolute-position mask."""
    B, C, _ = x.shape
    pos = start + torch.arange(C, device=x.device)  # (C,) absolute positions
    q, k, v = _qkv(p, x, cfg, pos[None, :])
    live = torch.arange(C, device=x.device) < n_real
    _paged_write(cache["k"], bt_row, pos, k[0], live=live)
    _paged_write(cache["v"], bt_row, pos, v[0], live=live)
    kk = gather_pages(cache["k"], bt_row[None])
    vv = gather_pages(cache["v"], bt_row[None])
    out = _chunk_masked_attention(q, kk, vv, pos[None, :])
    return nn.dense(p["wo"], out.reshape(B, C, -1)), cache
