"""Decoder-only LM, dense, moe, ssm and hybrid families: init, forward,
prefill and decode.

The port's counterpart of the dense and moe (GQA attention, routed experts),
ssm (mamba2) and hybrid (zamba2) families of ``repro/models/lm.py``.  The
params tree mirrors the reference's: ``embed``, ``final_norm``, ``lm_head``
where the head is not tied, and a ``layers`` subtree whose leaves are
stacked over layers, shape (L, ...); a moe layer holds ``moe`` (router,
(L, E, ...) expert stacks) where a dense one holds ``mlp``, and a mamba
layer ``ssm_in_norm`` and ``mamba``.  The hybrid family adds ONE unstacked
``shared_attn`` block (attention + MLP) applied after every full segment of
``attn_every`` mamba layers, with tied weights.  The reference scans over
the layer axis; here a Python loop takes each layer's slice (a view).

The decode cache is ``{"layers": {"k": (L, B, S, KV, hd), "v": ...}}`` (a
mamba layer: its conv tails and fp32 state, ``models/ssm.py``); the hybrid
family's adds ``"shared_attn": {"k": (n_apps, B, S, KV, hd), ...}``, one
cache per application of the shared block.  ``lm_decode_step`` updates it
IN PLACE: each layer writes its new K/V row (or its state) into its slice
of the stacked tensors.  This replaces the reference's scan-carry cache
(``lm.py:795-822``), whose point was the same in-place aliasing.  The
paged cache (``lm_init_cache_paged``) holds the K/V leaves as page pools,
``(L, P + 1, page, KV, hd)``, plus a ``"block_table": (B, n_tbl)``; the
conv tails and states stay slot-resident.  Its ``block_table`` routes
``lm_decode_step``'s attention through the paged decode, and
``lm_prefill_chunk`` writes one chunk of one slot's prompt into its pages
(dense and moe only: a recurrent state cannot be prefilled in page-backed
chunks).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import lowrank
from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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


_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not yet ported (only {', '.join(_FAMILIES)})")
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


def _block_init(generator, cfg, dtype, device, *, layer_kind: str) -> dict:
    """One block: ``mamba`` (norm + Mamba2), or attention with a routed
    (``moe``) or dense (``gqa``) feed-forward half."""
    if layer_kind == "mamba":
        return {"ssm_in_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm_mod.mamba2_init(generator, cfg, dtype, device)}
    p = {
        "attn_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "mlp_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if layer_kind == "moe":
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        p["mlp"] = moe_mod.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _layer_kind(cfg) -> str:
    """The kind of every stacked layer of the family."""
    return {"dense": "gqa", "moe": "moe", "ssm": "mamba", "hybrid": "mamba"}[cfg.family]


def _hybrid_segments(cfg):
    """[(n_mamba_layers, apply_shared_attn_after)] covering n_layers
    (``repro/models/lm.py::_hybrid_segments``): the shared block fires after
    every full ``attn_every`` segment, the trailing partial one gets none
    (zamba2's 38 layers at 6: segments 6,6,6,6,6,6,2 and 6 applications)."""
    segs, done = [], 0
    while done < cfg.n_layers:
        n = min(cfg.attn_every, cfg.n_layers - done)
        done += n
        segs.append((n, n == cfg.attn_every))
    return segs


def _schedule(cfg):
    """The blocks in the order the trunk runs them: ("layer", i) for stacked
    layer i, and (hybrid) ("shared", j) for the shared block's j-th
    application, with its own cache entry j."""
    if cfg.family != "hybrid":
        return [("layer", i) for i in range(cfg.n_layers)]
    out, i, j = [], 0, 0
    for n, with_attn in _hybrid_segments(cfg):
        out += [("layer", k) for k in range(i, i + n)]
        i += n
        if with_attn:
            out.append(("shared", j))
            j += 1
    return out


def _n_shared_apps(cfg) -> int:
    return sum(1 for kind, _ in _schedule(cfg) if kind == "shared")


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
    kind = _layer_kind(cfg)
    p["layers"] = _stack([_block_init(generator, cfg, dtype, device, layer_kind=kind) for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_init(generator, cfg, dtype, device, layer_kind="gqa")
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


def _mamba_block(lp, x, cfg, *, return_cache: bool = False):
    h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
    if not return_cache:
        return x + ssm_mod.mamba2_forward(lp["mamba"], h, cfg), None
    o, c = ssm_mod.mamba2_forward(lp["mamba"], h, cfg, return_cache=True)
    return x + o, c


def lm_forward(p, batch, cfg):
    """batch['tokens']: (B, S) -> (logits fp32 (B, S, Vp), aux_loss): the
    sum of the moe layers' load-balance losses (0.0 for any other family)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = nn.embed_lookup(p["embed"], tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = 0.0
    mamba = _layer_kind(cfg) == "mamba"
    for kind, i in _schedule(cfg):
        if kind == "shared":
            x, _, _ = _self_block(p["shared_attn"], x, cfg, positions)
        elif mamba:
            x, _ = _mamba_block(_layer(p["layers"], i), x, cfg)
        else:
            x, _, a = _self_block(_layer(p["layers"], i), x, cfg, positions)
            aux = aux + a
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, x, cfg), aux


def _stacked_zeros(one: dict, n: int, device) -> dict:
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=device) for k, v in one.items()}


def lm_init_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    _check_family(cfg)
    if _layer_kind(cfg) == "mamba":
        one = ssm_mod.mamba2_init_cache(cfg, batch_size, _dtype(cfg), device)
    else:
        one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
    cache = {"layers": _stacked_zeros(one, cfg.n_layers, device)}
    if cfg.family == "hybrid":
        one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
        cache["shared_attn"] = _stacked_zeros(one, _n_shared_apps(cfg), device)
    return cache


def lm_init_cache_paged(cfg, batch_size: int, max_len: int, *, page_size: int, n_pages: int, device):
    """Paged decode cache: physical page pools plus a per-slot block table.

    The per-token K/V leaves trade their (B, S) slot reservation for
    (n_pages + 1, page_size) pools shared by every slot (the +1 is the
    trailing trash page, ``attention.trash_page``).  The (batch, max_pages)
    int32 ``block_table`` starts on the trash id; the engine rewrites a
    slot's row at admission; every layer shares it.

    Returns ``(cache, paged_mask)``: the mask mirrors the cache (without the
    block table) with one bool per leaf, telling the engine which prefill
    scatter each leaf takes — pages for the K/V leaves (every leaf of the
    dense and moe families, the hybrid's ``shared_attn``), the slot row for
    the mamba layers' conv tails and states, which are O(1) per slot
    (``False``, as in ``repro/models/lm.py:392-395``).  A mamba2 cache has
    no paged leaf at all.
    """
    _check_family(cfg)
    n_phys = n_pages + 1
    if _layer_kind(cfg) == "mamba":
        one, paged = ssm_mod.mamba2_init_cache(cfg, batch_size, _dtype(cfg), device), False
    else:
        one, paged = attn.gqa_init_cache_paged(cfg, page_size, n_phys, _dtype(cfg), device)
    cache = {"layers": _stacked_zeros(one, cfg.n_layers, device)}
    mask = {"layers": {k: paged for k in one}}
    if cfg.family == "hybrid":
        kv, kv_paged = attn.gqa_init_cache_paged(cfg, page_size, n_phys, _dtype(cfg), device)
        cache["shared_attn"] = _stacked_zeros(kv, _n_shared_apps(cfg), device)
        mask["shared_attn"] = {k: kv_paged for k in kv}
    max_pages = -(-max_len // page_size)
    cache["block_table"] = torch.full((batch_size, max_pages), n_pages, dtype=torch.int32, device=device)
    return cache, mask


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
    mamba = _layer_kind(cfg) == "mamba"
    for kind, i in _schedule(cfg):
        if kind == "layer" and mamba:
            x, c = _mamba_block(_layer(p["layers"], i), x, cfg, return_cache=True)
            for name, t in c.items():
                cache["layers"][name][i] = t
            continue
        # an attention block: a stacked layer, or the hybrid's shared block
        # with its own cache per application
        lp, sub = (p["shared_attn"], "shared_attn") if kind == "shared" else (_layer(p["layers"], i), "layers")
        x, (k, v), _ = _self_block(lp, x, cfg, positions, return_cache=True)
        cache[sub]["k"][i, :, :S] = k
        cache[sub]["v"][i, :, :S] = v
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
    chunk's last REAL token; the pools are updated in place.  The dense and
    moe families only: an ssm or hybrid prefill carries recurrent state
    across the whole prompt.
    """
    _check_family(cfg)
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"chunked prefill unsupported for family {cfg.family!r}")
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
    decode in every attention block; the mamba layers' conv tails and
    states are slot rows either way."""
    _check_family(cfg)
    x = nn.embed_lookup(p["embed"], tokens)
    pos_v = attn.position_vector(pos, tokens.shape[0], tokens.device)  # once per step, on the device
    bt = cache.get("block_table")
    mamba = _layer_kind(cfg) == "mamba"
    for kind, i in _schedule(cfg):
        if kind == "layer" and mamba:
            lp = _layer(p["layers"], i)
            h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
            x = x + ssm_mod.mamba2_decode(lp["mamba"], h, _layer(cache["layers"], i), cfg)[0]
            continue
        if kind == "shared":
            lp, c = p["shared_attn"], _layer(cache["shared_attn"], i)
        else:
            lp, c = _layer(p["layers"], i), _layer(cache["layers"], i)  # views into the stacked cache
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
