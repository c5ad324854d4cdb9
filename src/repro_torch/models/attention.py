"""Grouped-query attention (GQA) and multi-head latent attention (MLA):
prefill through the flash kernel, decode over an in-place cache — flat, or
a pool of pages behind a block table — and page-backed prefill chunks.

The port's counterpart of the GQA and MLA parts of
``repro/models/attention.py``.
The attention kernels go through ``repro_torch.runtime.dispatch``.  Where
the reference returns updated caches, the port writes the cache tensors
IN PLACE and returns the same tensors.

Sliding-window archs (``cfg.sliding_window`` W, h2o-danube) keep a RING
cache of ``min(max_len, W)`` slots: absolute position p lives in slot
p % W, so a decode of any length holds O(W) of K/V.  The prefill attends
through the flash kernel's window and hands back the ring-ordered tail of
a prompt longer than W; a decode step writes slot pos % W and, once the
ring is full, attends every slot.  The ring is never paged
(``gqa_init_cache_paged`` returns ``paged=False``): paging a
window-bounded cache banks nothing.

MLA (deepseek-v2) caches a latent per token, ``c_kv`` (kv_lora_rank) and
the rope-applied ``k_rope`` (qk_rope_dim), instead of per-head K/V.  The
prefill materializes per-head K (nope + rope, 192 at full width) and V
(128) from the latent and attends through the flash kernel; decode and the
page-backed chunk prefill run the reference's absorbed-weight attention in
latent space, as torch ops (``dispatch.mla_product``): the reference
computes them in XLA, outside any Pallas kernel.

Cross-attention (llama-3.2-vision's image layers, whisper's decoder)
attends ``n_heads`` query heads over as many K/V heads (G = 1) computed
from a context (image embeddings, encoder states) once per request, with
no rotary embedding and no mask: through the flash kernel's non-causal
path at prefill and at decode alike (Sq = 1 there), as the reference
runs ``chunked_attention(causal=False)`` in both.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF, gather_pages
from repro_torch.models import modules as nn
from repro_torch.runtime import distributed
from repro_torch.sharding.rules import leaf_spec

__all__ = [
    "position_vector",
    "gqa_init",
    "gqa_forward",
    "gqa_init_cache",
    "gqa_decode",
    "decode_attention",
    "paged_decode_attention",
    "trash_page",
    "copy_page",
    "gqa_init_cache_paged",
    "gqa_decode_paged",
    "gqa_prefill_chunk",
    "cross_attn_init",
    "cross_attn_kv",
    "cross_attn",
    "mla_init",
    "mla_forward",
    "mla_init_cache",
    "mla_decode",
    "mla_init_cache_paged",
    "mla_decode_paged",
    "mla_prefill_chunk",
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


def decode_attention(q, k_cache, v_cache, n_valid, *, return_lse: bool = False):
    """One-token attention over a cache.  q: (B, 1, H, hd); caches
    (B, S, KV, *).  ``n_valid``: valid cache slots — a scalar or a (B,)
    vector; masking is strictly per sequence.  A fully-masked row produces
    zeros (and with ``return_lse`` an lse of -inf)."""
    from repro_torch.runtime import dispatch

    B, S = q.shape[0], k_cache.shape[1]
    nv = position_vector(n_valid, B, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < nv[:, None]
    return dispatch.decode_attention(q, k_cache, v_cache, valid, return_lse=return_lse)


def cache_block(S: int, tp) -> tuple:
    """(first slot, slots) of a decode cache of ``S`` slots (positions, or a
    ring's) that this rank holds: the reference's ``cache_specs`` split the
    slots over "model" where they divide, and keep the cache whole
    otherwise (and without ``tp``)."""
    if tp is None or tp.size == 1 or S % tp.size:
        return 0, S
    n = S // tp.size
    return tp.index * n, n


def _combine_split(out, lse, tp):
    """The attentions of this rank's cache slots (out (B, 1, H, vd), fp32
    lse (B, H)) combined over "model" exactly by their log-sum-exp: each
    rank's output weighted by exp(lse - max lse), summed (one all-reduce of
    the weighted outputs and the weights), divided by the summed weights."""
    m = distributed.pmax(lse, "model", tp.mesh)
    w = torch.exp(lse - m)  # a rank with no valid slot: exp(-inf) = 0
    B, _, H, vd = out.shape
    part = torch.cat([(out.float() * w[:, None, :, None]).reshape(B, -1), w], dim=1)
    tot = distributed.psum(part, "model", tp.mesh)
    num, den = tot[:, :H * vd].reshape(B, 1, H, vd), tot[:, H * vd:]
    return (num / den[:, None, :, None]).to(out.dtype)


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


def _heads_split(tp, n_heads: int) -> bool:
    """Whether the reference's head constraint splits ``n_heads`` over
    "model" (``rules.resolve("tp", heads)``; minitron-4b's 24 query heads
    do not divide 16, so its q stays whole there)."""
    return tp is not None and tp.size > 1 and n_heads % tp.size == 0


def _proj_tp(p, name: str, x, cfg, tp, n_heads: int, bias: str):
    """One of q / k / v under ``tp``: (B, S, heads, hd) on this rank's heads
    where they split over "model" (True), else every head (False), the
    projection's column blocks gathered (they hold parts of heads)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    shape = (cfg.d_model, n_heads * hd)
    y = nn.tp_linear(tp, p[name], x, "attn/" + name, shape)
    cols = leaf_spec("attn/" + name, shape)[1] == "model"  # else the projection came out whole
    if cfg.qkv_bias:  # the bias's rule splits the same dim, or keeps it whole with the projection
        y = y + (p[bias] if cols else tp.copy(p[bias]))
    split = _heads_split(tp, n_heads)
    if not split and cols:
        y = tp.gather_features(y)  # a block holds part of a head
    return y.reshape(B, S, -1, hd), split


def _local_kv(k, v, cfg, tp, q_split: bool, kv_split: bool):
    """K/V heads for this rank's query heads: its own where both split,
    every head where the queries do not, and where only the queries split
    (half a KV head a rank and the like) the one KV head they all read:
    "model" is then a multiple of the KV heads, at every config of the
    families."""
    if not q_split or kv_split:
        return k, v
    KV = cfg.n_kv_heads
    if tp.size % KV:
        raise ValueError(f"{KV} KV heads over \"model\" ({tp.size}): neither divides the other")
    lo = tp.index * KV // tp.size
    return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1]


def _qkv(p, x, cfg, positions, *, rope: bool = True, tp=None):
    """(q, k, v) (B, S, heads, hd).  Under ``tp`` x is the region's input
    (whole rows) and q / k / v lie on their heads' layout (:func:`_proj_tp`);
    also returns (q split, k/v split)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if tp is not None:
        q, q_split = _proj_tp(p, "wq", x, cfg, tp, H, "bq")
        k, kv_split = _proj_tp(p, "wk", x, cfg, tp, KV, "bk")
        v, _ = _proj_tp(p, "wv", x, cfg, tp, KV, "bv")
        if rope:
            q = nn.apply_rope(q, positions, cfg.rope_theta)
            k = nn.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v.contiguous(), (q_split, kv_split)
    q = nn.dense(p["wq"], x)
    k = nn.dense(p["wk"], x)
    v = nn.dense(p["wv"], x)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd)
    if rope:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd).contiguous()
    return q, k, v


def _out_tp(p, out, cfg, tp, q_split: bool):
    """The attention output (B, S, heads, vd) through ``wo``, leaving the
    region: this rank's heads are wo's row block where the heads split;
    otherwise every head was computed here, sliced to that block (or kept
    whole where wo itself is whole over "model")."""
    B, S = out.shape[:2]
    shape = (cfg.n_heads * cfg.head_dim, cfg.d_model)
    out = out.reshape(B, S, -1)
    if not q_split and leaf_spec("attn/wo", shape)[0] == "model":
        out = tp.own_features(out)
    return nn.tp_linear(tp, p["wo"], out, "attn/wo", shape, row=True)


def gqa_forward(p, x, cfg, *, positions=None, causal: bool = True, rope: bool = True,
                return_cache: bool = False, tp=None):
    """Full-sequence GQA attention (prefill), through the flash kernel.
    ``rope=False`` (whisper's encoder and decoder prompt) applies no rotary
    embedding; ``causal=False`` (whisper's encoder) masks nothing.

    Returns the output, and with ``return_cache`` also the (k, v) of every
    position for the decode cache.  Under ``tp`` (``models/modules.py``)
    ``x`` is this rank's rows of the residual stream's layout: the rows
    enter the region, the flash kernel runs on this rank's heads (every
    head where the query heads do not divide over "model"), and ``wo``
    leaves it; the cache rows come back with every KV head."""
    from repro_torch.runtime import dispatch

    W = cfg.sliding_window
    if tp is not None:
        x = tp.enter(x)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if tp is not None:
        q, k, v, (q_split, kv_split) = _qkv(p, x, cfg, positions, rope=rope, tp=tp)
        kq, vq = _local_kv(k, v, cfg, tp, q_split, kv_split)
        out = dispatch.flash_attention(q, kq.contiguous(), vq.contiguous(), causal=causal, window=W)
        out = _out_tp(p, out, cfg, tp, q_split)
        if return_cache and kv_split:  # the cache holds every KV head
            k = distributed.all_gather(k, "model", tp.mesh, dim=2)
            v = distributed.all_gather(v, "model", tp.mesh, dim=2)
    else:
        q, k, v = _qkv(p, x, cfg, positions, rope=rope)
        out = dispatch.flash_attention(q, k, v, causal=causal, window=W)
        out = nn.dense(p["wo"], out.reshape(B, S, -1))
    if not return_cache:
        return out
    if W is not None and S > W:
        # the ring keeps the last W positions, absolute position p in slot p % W:
        # tail row i (position S - W + i) goes to slot (i + S) % W
        return out, (torch.roll(k[:, -W:], S % W, dims=1), torch.roll(v[:, -W:], S % W, dims=1))
    return out, (k, v)


def gqa_init_cache(cfg, batch: int, max_len: int, dtype, device, tp=None) -> dict:
    """A cache of ``max_len`` positions a row; a sliding window W's ring of
    ``min(max_len, W)``.  Under ``tp`` this rank's block of its slots
    (:func:`cache_block`)."""
    KV, hd, W = cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window
    S = cache_block(min(max_len, W) if W is not None else max_len, tp)[1]
    return {
        "k": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
    }


def gqa_decode(p, x, cache, pos, cfg, tp=None, slots=None):
    """x: (B, 1, d); pos: absolute position of the new token — a scalar or a
    (B,) vector (``lm_decode_step`` passes one (B,) device vector to every
    layer).  Writes the new K/V into ``cache`` IN PLACE (the tensors may be
    views of the model's stacked (L, B, S, KV, hd) cache) and returns
    (out, cache).  Under ``tp`` the cache is this rank's block of the
    ``slots`` slots of the whole (``cache_specs``' layout, :func:`cache_block`)
    and every query head attends it.  Where the slots split over "model" the
    new row's K/V (every head) is written only by the rank that holds slot
    ``pos % slots`` and the ranks' attentions are combined exactly by their
    log-sum-exp (:func:`_combine_split`); where they do not, every rank holds
    and writes the whole cache and attends it unsplit.  The output is sliced
    to wo's row block."""
    B = x.shape[0]
    pos_v = position_vector(pos, B, x.device)
    if tp is not None:
        q, k, v, (q_split, kv_split) = _qkv(p, tp.enter(x), cfg, pos_v[:, None], tp=tp)
        if q_split:
            q = distributed.all_gather(q, "model", tp.mesh, dim=2)
        if kv_split:
            k = distributed.all_gather(k, "model", tp.mesh, dim=2)
            v = distributed.all_gather(v, "model", tp.mesh, dim=2)
    else:
        q, k, v = _qkv(p, x, cfg, pos_v[:, None])
    b_idx = torch.arange(B, device=x.device)
    S = cache["k"].shape[1] if tp is None else slots
    lo, n_loc = cache_block(S, tp)
    split = n_loc != S
    slot = pos_v % S  # the ring for SWA; identity while pos < max_len otherwise, as in the reference
    if not split:
        cache["k"][b_idx, slot] = k[:, 0]
        cache["v"][b_idx, slot] = v[:, 0]
    else:  # only the rank holding the slot writes (the others rewrite a row with itself)
        own = ((slot >= lo) & (slot < lo + n_loc))[:, None, None]
        li = torch.clamp(slot - lo, 0, n_loc - 1)
        cache["k"][b_idx, li] = torch.where(own, k[:, 0], cache["k"][b_idx, li])
        cache["v"][b_idx, li] = torch.where(own, v[:, 0], cache["v"][b_idx, li])
    n_valid = pos_v + 1
    if cfg.sliding_window is not None and S == cfg.sliding_window:
        # a full ring holds the window exactly: every slot is valid once pos >= S - 1 (a
        # device-side clamp, no host sync: the decode block is captured as a CUDA graph)
        n_valid = torch.clamp(n_valid, max=S)
    if split:
        out, lse = decode_attention(q, cache["k"], cache["v"], torch.clamp(n_valid - lo, 0, n_loc), return_lse=True)
        return _out_tp(p, _combine_split(out, lse, tp), cfg, tp, False), cache
    out = decode_attention(q, cache["k"], cache["v"], n_valid)
    if tp is not None:
        return _out_tp(p, out, cfg, tp, False), cache
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


def copy_page(pool, src: int, dst: int, *, axis: int = 0):
    """Copy physical page ``src`` onto ``dst`` along the pool's page
    ``axis``, IN PLACE: the copy-on-write fork of shared-prefix serving.

    Shared block-table entries are read-only: when a slot's prefill must
    re-enter the last matched prefix page (the whole prompt was covered,
    but its last token still runs to produce the sampling logits), the
    engine forks that page with this and points the slot's table at the
    copy, so the writer never mutates storage other slots read.  One
    indexed ``copy_`` on the current stream (an XLA scatter in the
    reference, not a Pallas kernel).  Returns ``pool``."""
    pool.select(axis, dst).copy_(pool.select(axis, src))
    return pool


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
    masked p of 0 times a NaN left in V would still be NaN.  A
    sliding-window arch returns ``(None, False)``: its O(window) ring stays
    slot-resident and the caller builds it with :func:`gqa_init_cache`."""
    if cfg.sliding_window is not None:
        return None, False
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


# --------------------------------------------------------------------------- #
# Cross-attention (llama-3.2-vision's image layers, whisper's decoder)
# --------------------------------------------------------------------------- #
def cross_attn_init(generator: torch.Generator, cfg, dtype, device) -> dict:
    d, Hhd = cfg.d_model, cfg.n_heads * cfg.head_dim
    return {
        "wq": nn.dense_init(generator, d, Hhd, dtype, device),
        "wk": nn.dense_init(generator, d, Hhd, dtype, device),
        "wv": nn.dense_init(generator, d, Hhd, dtype, device),
        "wo": nn.dense_init(generator, Hhd, d, dtype, device, scale=Hhd**-0.5),
    }


def cross_attn_kv(p, ctx, cfg):
    """The cross K/V, (B, T, n_heads, head_dim) each, of a context (B, T, d):
    computed once a request and kept in the slot's ``cross_kv`` rows."""
    B, T, _ = ctx.shape
    H, hd = cfg.n_heads, cfg.head_dim
    return nn.dense(p["wk"], ctx).reshape(B, T, H, hd), nn.dense(p["wv"], ctx).reshape(B, T, H, hd)


def cross_attn(p, x, kv, cfg):
    """x (B, S, d) attends every context position of ``kv`` (no mask, no
    rotary embedding), through the flash kernel's non-causal path; S is the
    prompt at prefill and 1 at decode."""
    from repro_torch.runtime import dispatch

    B, S, _ = x.shape
    q = nn.dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    out = dispatch.flash_attention(q, kv[0], kv[1], causal=False)
    return nn.dense(p["wo"], out.reshape(B, S, -1))


# --------------------------------------------------------------------------- #
# MLA — multi-head latent attention (deepseek-v2)
# --------------------------------------------------------------------------- #
def mla_init(generator: torch.Generator, cfg, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": nn.dense_init(generator, d, lq, dtype, device),
        "q_norm": nn.rmsnorm_init(lq, dtype, device),
        "wq_b": nn.dense_init(generator, lq, H * (nope + rope_d), dtype, device),
        "wkv_a": nn.dense_init(generator, d, lkv + rope_d, dtype, device),
        "kv_norm": nn.rmsnorm_init(lkv, dtype, device),
        "wkv_b": nn.dense_init(generator, lkv, H * (nope + vd), dtype, device),
        "wo": nn.dense_init(generator, H * vd, d, dtype, device, scale=(H * vd) ** -0.5),
    }


def _mla_q(p, x, cfg, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) rope-applied)."""
    B, S, _ = x.shape
    H, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = nn.rmsnorm(p["q_norm"], nn.dense(p["wq_a"], x), cfg.norm_eps)
    q = nn.dense(p["wq_b"], ql).reshape(B, S, H, nope + rope_d)
    return q[..., :nope], nn.apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    """(c_kv normed (B, S, lkv), k_rope (B, S, rope) rope-applied)."""
    lkv = cfg.kv_lora_rank
    kv_a = nn.dense(p["wkv_a"], x)
    c_kv = nn.rmsnorm(p["kv_norm"], kv_a[..., :lkv], cfg.norm_eps)
    k_rope = nn.apply_rope(kv_a[..., lkv:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(p, x, cfg, *, positions=None, return_cache: bool = False):
    """Prefill MLA: per-head K = [k_nope, k_rope broadcast over heads] and V
    are materialized from the latent, and attend through the flash kernel at
    q/k head dim nope + rope and v head dim ``v_head_dim``.  With
    ``return_cache`` also the latent cache rows (c_kv, k_rope)."""
    from repro_torch.runtime import dispatch

    B, S, _ = x.shape
    H, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    kv = nn.dense(p["wkv_b"], c_kv).reshape(B, S, H, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = dispatch.flash_attention(q, k, kv[..., nope:].contiguous(), causal=True)
    out = nn.dense(p["wo"], out.reshape(B, S, -1))
    if not return_cache:
        return out
    return out, (c_kv, k_rope)


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
    }


def _mla_absorbed_weights(p, cfg):
    """(w_uk (lkv, H, nope), w_uv (lkv, H, vd)): views of the dense ``wkv_b``,
    materialized on every call where it is factored (as the reference)."""
    from repro_torch.runtime import dispatch

    H, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    w_kv = dispatch.mla_materialize(p["wkv_b"]).reshape(cfg.kv_lora_rank, H, nope + vd)
    return w_kv[..., :nope], w_kv[..., nope:]


def _mla_scores_and_context(p, cfg, q_nope, q_rope, c_cache, r_cache, valid, live):
    """The absorbed-weight latent attention of the flat decode, the paged
    decode and the paged chunk prefill (``repro/models/attention.py``'s, with
    its rounding points).  q_nope / q_rope: (B, C, H, *) queries (C == 1 for
    decode); caches: (B, S, *) latent views; valid: (B, C, S) bool, what
    each query attends; live: (B, S) bool, the positions that hold written
    rows (every valid position is live).  Returns (B, C, H * vd) fp32, pre-``wo``.

    A masked position weighs exactly 0, but the context product still
    multiplies it by what the cache holds there: a row never written (a
    gathered trash page, a recycled page's old contents) is zeroed first,
    so nothing non-finite there can reach a live query."""
    from repro_torch.runtime import dispatch

    B, C, H, _ = q_nope.shape
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    f32 = torch.float32
    w_uk, w_uv = _mla_absorbed_weights(p, cfg)
    # absorb: q_lat[b,c,h,l] = sum_n q_nope[b,c,h,n] w_uk[l,h,n], rounded to the cache dtype
    q_lat = dispatch.mla_product("bchn,lhn->bchl", q_nope, w_uk, out_dtype=c_cache.dtype)
    s = (dispatch.mla_product("bchl,bsl->bchs", q_lat, c_cache, out_dtype=f32)
         + dispatch.mla_product("bchr,bsr->bchs", q_rope, r_cache, out_dtype=f32)) * (nope + rope_d) ** -0.5
    s = torch.where(valid[:, :, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    c_live = torch.where(live[..., None], c_cache, torch.zeros_like(c_cache))
    ctx_lat = dispatch.mla_product("bchs,bsl->bchl", w.to(c_cache.dtype), c_live, out_dtype=c_cache.dtype)
    out = dispatch.mla_product("bchl,lhv->bchv", ctx_lat, w_uv, out_dtype=f32)
    return out.reshape(B, C, H * vd)


def mla_decode(p, x, cache, pos, cfg):
    """Absorbed-weight MLA decode, attention entirely in latent space.  x:
    (B, 1, d); ``pos`` a scalar or a (B,) vector.  Writes the new latent row
    into ``cache`` IN PLACE and returns (out, cache)."""
    B = x.shape[0]
    pos_v = position_vector(pos, B, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos_v[:, None])
    c_new, kr_new = _mla_latent(p, x, cfg, pos_v[:, None])
    b_idx = torch.arange(B, device=x.device)
    cache["c_kv"][b_idx, pos_v] = c_new[:, 0]
    cache["k_rope"][b_idx, pos_v] = kr_new[:, 0]
    valid = torch.arange(cache["c_kv"].shape[1], device=x.device)[None, :] <= pos_v[:, None]
    out = _mla_scores_and_context(p, cfg, q_nope, q_rope, cache["c_kv"], cache["k_rope"], valid[:, None], valid)
    return nn.dense(p["wo"], out.to(x.dtype)), cache


def mla_init_cache_paged(cfg, page_size: int, n_pages_phys: int, dtype, device):
    """Latent page pools, (P, page, kv_lora_rank) and (P, page, qk_rope_dim):
    the MLA twin of :func:`gqa_init_cache_paged`.  Returns ``(cache, True)``."""
    return {
        "c_kv": torch.zeros((n_pages_phys, page_size, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((n_pages_phys, page_size, cfg.qk_rope_dim), dtype=dtype, device=device),
    }, True


def mla_decode_paged(p, x, cache, pos, cfg, block_table):
    """Paged twin of :func:`mla_decode`: the latent rows are written through
    the block table (in place) and scored over the gathered logical view."""
    B = x.shape[0]
    pos_v = position_vector(pos, B, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos_v[:, None])
    c_new, kr_new = _mla_latent(p, x, cfg, pos_v[:, None])
    _paged_write(cache["c_kv"], block_table, pos_v, c_new[:, 0])
    _paged_write(cache["k_rope"], block_table, pos_v, kr_new[:, 0])
    c_cache = gather_pages(cache["c_kv"], block_table)  # (B, S_log, lkv)
    r_cache = gather_pages(cache["k_rope"], block_table)
    valid = torch.arange(c_cache.shape[1], device=x.device)[None, :] <= pos_v[:, None]
    out = _mla_scores_and_context(p, cfg, q_nope, q_rope, c_cache, r_cache, valid[:, None], valid)
    return nn.dense(p["wo"], out.to(x.dtype)), cache


def mla_prefill_chunk(p, x, cache, cfg, bt_row, start: int, n_real: int):
    """One page-backed MLA prefill chunk for a single slot (B == 1), with
    :func:`gqa_prefill_chunk`'s write-then-attend contract: the chunk's
    latent rows go into the slot's pages first (padded rows to the trash
    page), then every row attends the gathered view up to its position."""
    B, C, _ = x.shape
    pos = start + torch.arange(C, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos[None, :])
    c_new, kr_new = _mla_latent(p, x, cfg, pos[None, :])
    live_rows = torch.arange(C, device=x.device) < n_real
    _paged_write(cache["c_kv"], bt_row, pos, c_new[0], live=live_rows)
    _paged_write(cache["k_rope"], bt_row, pos, kr_new[0], live=live_rows)
    c_cache = gather_pages(cache["c_kv"], bt_row[None])
    r_cache = gather_pages(cache["k_rope"], bt_row[None])
    span = torch.arange(c_cache.shape[1], device=x.device)
    valid = span[None, None, :] <= pos[None, :, None]
    live = span[None, :] < start + n_real
    out = _mla_scores_and_context(p, cfg, q_nope, q_rope, c_cache, r_cache, valid, live)
    return nn.dense(p["wo"], out.to(x.dtype)), cache
