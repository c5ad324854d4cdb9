"""Decoder-only LM, dense and moe families: init, forward, prefill and decode.

The port's counterpart of the dense and moe (GQA attention, routed experts)
families of ``repro/models/lm.py``.  The params tree mirrors the
reference's: ``embed``, ``final_norm``, ``lm_head`` where the head is not
tied, and a ``layers`` subtree whose leaves are stacked over layers, shape
(L, ...); a moe layer holds ``moe`` (router, (L, E, ...) expert stacks)
where a dense one holds ``mlp``.  The reference scans over the layer axis;
here a Python loop takes each layer's slice (a view).

The decode cache is ``{"layers": {"k": (L, B, S, KV, hd), "v": ...}}`` and
``lm_decode_step`` updates it IN PLACE: each layer writes its new K/V row
into its slice of the stacked tensors.  This replaces the reference's
scan-carry cache (``lm.py:795-822``), whose point was the same in-place
aliasing.  The paged cache (``lm_init_cache_paged``) holds
``{"layers": {"k": (L, P + 1, page, KV, hd), ...}, "block_table": (B, n_tbl)}``
instead; its ``block_table`` routes ``lm_decode_step`` through the paged
decode, and ``lm_prefill_chunk`` writes one chunk of one slot's prompt into
its pages.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import lowrank
from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moe_mod
from repro_torch.runtime import dispatch

__all__ = [
    "lm_init",
    "lm_forward",
    "lm_init_cache",
    "lm_init_cache_paged",
    "lm_prefill",
    "lm_prefill_chunk",
    "lm_decode_step",
]


# what the port does not carry yet, and the slice that brings it
_LATER_MOE = {
    "kv_lora_rank": "MLA attention comes with the deepseek-v2 slice",
    "first_dense_layers": "dense first layers come with the deepseek-v2 slice",
    "n_shared_experts": "shared experts in a served model come with the deepseek-v2 slice",
}


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"model family {cfg.family!r} is not yet ported (only 'dense' and 'moe')")
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window attention is not yet ported")
    if cfg.family == "moe":
        for field, later in _LATER_MOE.items():
            if getattr(cfg, field):
                raise NotImplementedError(f"moe with {field}={getattr(cfg, field)} is not yet ported: {later}")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(stack, i: int):
    """Layer ``i``'s slice of a stacked params (or cache) subtree."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _block_init(generator, cfg, dtype, device) -> dict:
    p = {
        "attn_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "mlp_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = moe_mod.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def lm_init(generator: torch.Generator, cfg, device) -> dict:
    """Random params (seeded by ``generator``) in the reference's tree layout."""
    _check_family(cfg)
    dtype = _dtype(cfg)
    p = {
        "embed": nn.embed_init(generator, cfg.vocab_padded, cfg.d_model, dtype, device),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(generator, cfg.d_model, cfg.vocab_padded, dtype, device)
    p["layers"] = _stack([_block_init(generator, cfg, dtype, device) for _ in range(cfg.n_layers)])
    return p


def _logits(p, x, cfg) -> torch.Tensor:
    """fp32 logits (``repro/models/lm.py::_logits``).  The tied embedding and
    a dense untied head give fp32-accumulated logits never rounded to the
    model dtype; a compressed head goes through ``nn.dense`` like any
    factored linear, so its logits ARE rounded to the model dtype first and
    then cast to fp32, as the reference's are."""
    if cfg.tie_embeddings:
        return dispatch.logits_apply(x, p["embed"])
    head = p["lm_head"]
    if lowrank.is_lowrank(head):
        return nn.dense(head, x).float()
    return dispatch.logits_apply(x, head, tied=False)


def _mlp(lp, h, cfg, *, with_aux: bool = False):
    """The block's feed-forward half: routed experts or the dense FFN.
    Returns (out, aux loss).  The aux loss is computed only ``with_aux``
    (lm_forward reads it; the serving paths skip its kernels) and is 0.0
    otherwise and for a dense model."""
    if "moe" not in lp:
        return moe_mod.ffn_forward(lp["mlp"], h), 0.0
    if with_aux:
        return moe_mod.moe_forward(lp["moe"], h, cfg)
    return moe_mod.moe_apply(lp["moe"], h, cfg), 0.0


def _self_block(lp, x, cfg, positions, *, return_cache: bool = False):
    h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a = attn.gqa_forward(lp["attn"], h, cfg, positions=positions, return_cache=return_cache)
    kv = None
    if return_cache:
        a, kv = a
    x = x + a
    h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    m, aux = _mlp(lp, h, cfg, with_aux=not return_cache)  # return_cache: the serving prefill
    return x + m, kv, aux


def lm_forward(p, batch, cfg):
    """batch['tokens']: (B, S) -> (logits fp32 (B, S, Vp), aux_loss): the
    sum of the moe layers' load-balance losses (0.0 for a dense model)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = nn.embed_lookup(p["embed"], tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = 0.0
    for i in range(cfg.n_layers):
        x, _, a = _self_block(_layer(p["layers"], i), x, cfg, positions)
        aux = aux + a
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, x, cfg), aux


def lm_init_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    _check_family(cfg)
    one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
    return {"layers": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype, device=device)
                       for k, v in one.items()}}


def lm_init_cache_paged(cfg, batch_size: int, max_len: int, *, page_size: int, n_pages: int, device):
    """Paged decode cache: physical page pools plus a per-slot block table.

    The per-token K/V leaves trade their (B, S) slot reservation for
    (n_pages + 1, page_size) pools shared by every slot (the +1 is the
    trailing trash page, ``attention.trash_page``).  The (batch, max_pages)
    int32 ``block_table`` starts on the trash id; the engine rewrites a
    slot's row at admission; every layer shares it.

    Returns ``(cache, paged_mask)``: the mask mirrors the cache (without the
    block table) with one bool per leaf, telling the engine which prefill
    scatter each leaf takes — pages, for every leaf of the dense and moe
    families.
    """
    _check_family(cfg)
    one, paged = attn.gqa_init_cache_paged(cfg, page_size, n_pages + 1, _dtype(cfg), device)
    layers = {k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype, device=device)
              for k, v in one.items()}
    max_pages = -(-max_len // page_size)
    cache = {"layers": layers,
             "block_table": torch.full((batch_size, max_pages), n_pages, dtype=torch.int32, device=device)}
    return cache, {"layers": {k: paged for k in layers}}


def lm_prefill(p, batch, cfg, max_len: int, *, last_index: Optional[torch.Tensor] = None):
    """Run the prompt through the model, building the decode cache.

    Returns (last_token_logits (B, Vp) fp32, cache).  ``last_index``:
    optional (B,) index of each sequence's last valid prompt token (for
    right-padded micro-batches); by default the last column.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} > max_len {max_len}")
    cache = lm_init_cache(cfg, B, max_len, tokens.device)
    x = nn.embed_lookup(p["embed"], tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for i in range(cfg.n_layers):
        x, (k, v), _ = _self_block(_layer(p["layers"], i), x, cfg, positions, return_cache=True)
        cache["layers"]["k"][i, :, :S] = k
        cache["layers"]["v"][i, :, :S] = v
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    if last_index is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_index, dtype=torch.int64, device=x.device)
        last = x[torch.arange(B, device=x.device), idx][:, None, :]
    return _logits(p, last, cfg)[:, 0], cache


def lm_prefill_chunk(p, cache, tokens, cfg, *, bt_row, start: int, n_real: int):
    """One page-aligned chunk of one slot's prompt prefill (paged cache only).

    tokens: (1, C) — the chunk at absolute positions ``start + [0, C)``,
    right-padded when fewer than C real tokens remain (``n_real`` are
    real; padded rows write to the trash page).  ``bt_row``: the slot's
    (n_tbl,) page ids, passed EXPLICITLY rather than read from
    ``cache["block_table"]``: the engine keeps the slot's table row on
    trash until the last chunk lands, so the decode block's frozen-slot
    re-feeds cannot write into a half-prefilled slot's pages.

    Each layer writes the chunk's K/V into the slot's pages, then attends
    over the gathered logical cache with an absolute-position causal mask,
    so chunk after chunk computes what the monolithic prefill computes.
    Returns ``(last_logits (1, Vp) fp32, cache)``, the logits taken at the
    chunk's last REAL token; the pools are updated in place.
    """
    _check_family(cfg)
    B, C = tokens.shape
    bt_row = bt_row.reshape(-1)
    x = nn.embed_lookup(p["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = _layer(p["layers"], i)
        c = _layer(cache["layers"], i)  # views into the stacked pools
        h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        a, _ = attn.gqa_prefill_chunk(lp["attn"], h, c, cfg, bt_row, start, n_real)
        x = x + a
        h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + _mlp(lp, h, cfg)[0]
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    last = x[:, min(max(n_real - 1, 0), C - 1)][:, None, :]
    return _logits(p, last, cfg)[:, 0], cache


def lm_decode_step(p, cache, tokens, pos, cfg):
    """tokens: (B, 1); pos: scalar or (B,) per-slot positions.

    Returns (logits (B, Vp) fp32, cache); the cache is updated in place.  A
    cache with a ``block_table`` (``lm_init_cache_paged``) takes the paged
    decode in every layer."""
    _check_family(cfg)
    x = nn.embed_lookup(p["embed"], tokens)
    pos_v = attn.position_vector(pos, tokens.shape[0], tokens.device)  # once per step, on the device
    bt = cache.get("block_table")
    for i in range(cfg.n_layers):
        lp = _layer(p["layers"], i)
        c = _layer(cache["layers"], i)  # views into the stacked cache
        h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        if bt is not None:
            a, _ = attn.gqa_decode_paged(lp["attn"], h, c, pos_v, cfg, bt)
        else:
            a, _ = attn.gqa_decode(lp["attn"], h, c, pos_v, cfg)
        x = x + a
        h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + _mlp(lp, h, cfg)[0]
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, x, cfg)[:, 0], cache
