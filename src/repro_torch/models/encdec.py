"""Whisper-style encoder-decoder (the audio family; the frontend is a stub).

The port's counterpart of ``repro/models/encdec.py``.  The model consumes
precomputed frame embeddings ``frames`` (B, n_audio_frames, d_model) in
place of the conv mel-spectrogram frontend.  Positions are sinusoidal on
both sides (whisper's decoder learns them; the reference's deviation,
kept).  Pre-LayerNorm blocks with a GELU (tanh form) FFN:

* the encoder: ``n_encoder_layers`` blocks of non-causal self-attention
  without rotary embedding (the flash kernel's non-causal path over every
  frame), then ``enc_norm``;
* the decoder: ``n_layers`` blocks of causal self-attention, cross-attention
  over the encoder states, and the FFN, then ``dec_norm`` and an untied
  ``lm_head``.

The params tree mirrors the reference's: ``embed``, ``enc_layers`` and
``dec_layers`` stacked over layers, ``enc_norm``, ``dec_norm``,
``lm_head``; every linear goes through ``nn.dense``, so a factored leaf
takes the low-rank kernel.  The decode cache is ``{"self": {"k": (L, B, S,
H, hd), "v": ...}, "cross_kv": {"k": (L, B, n_audio_frames, H, hd), "v":
...}}``, updated IN PLACE; the paged cache holds ``self`` as page pools
plus a ``block_table`` and keeps ``cross_kv`` slot-resident.

As in the reference, the prompt's self-attention applies no rotary
embedding while each decode step's does (at ``rope_theta``, through the
shared GQA decode), so the cached prompt K was not rotated and the decoded
K is: a reference caveat the port reproduces, since greedy parity depends
on it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models.lm import _dtype, _layer, _stack, _stacked_zeros, remat_groups
from repro_torch.runtime import dispatch

__all__ = [
    "encdec_init",
    "encdec_encode",
    "encdec_forward_features",
    "encdec_forward",
    "encdec_head_apply",
    "encdec_init_cache",
    "encdec_init_cache_paged",
    "encdec_prefill",
    "encdec_decode_step",
]


def _ffn_init(generator, d: int, f: int, dtype, device) -> dict:
    return {"w_up": nn.dense_init(generator, d, f, dtype, device),
            "w_down": nn.dense_init(generator, f, d, dtype, device, scale=f**-0.5)}


def _ffn(p, x):
    return nn.dense(p["w_down"], nn.gelu(nn.dense(p["w_up"], x)))


def _enc_layer_init(generator, cfg, dtype, device) -> dict:
    return {
        "attn_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "mlp_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "mlp": _ffn_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _dec_layer_init(generator, cfg, dtype, device) -> dict:
    return {
        "attn_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "cross_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "cross": attn.cross_attn_init(generator, cfg, dtype, device),
        "mlp_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "mlp": _ffn_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def encdec_init(generator: torch.Generator, cfg, device) -> dict:
    """Random params (seeded by ``generator``) in the reference's tree layout."""
    dtype = _dtype(cfg)
    return {
        "embed": nn.embed_init(generator, cfg.vocab_padded, cfg.d_model, dtype, device),
        "enc_layers": _stack([_enc_layer_init(generator, cfg, dtype, device) for _ in range(cfg.n_encoder_layers)]),
        "enc_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "dec_layers": _stack([_dec_layer_init(generator, cfg, dtype, device) for _ in range(cfg.n_layers)]),
        "dec_norm": nn.layernorm_init(cfg.d_model, dtype, device),
        "lm_head": nn.dense_init(generator, cfg.d_model, cfg.vocab_padded, dtype, device),
    }


def _frames(batch, device) -> torch.Tensor:
    if "frames" not in batch:
        raise ValueError("an audio batch needs 'frames' (B, n_audio_frames, d_model)")
    return torch.as_tensor(batch["frames"], device=device)


def encdec_encode(p, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> encoder states (B, T, d)."""
    dtype = _dtype(cfg)
    T, d = frames.shape[1], frames.shape[2]
    x = frames.to(dtype) + nn.sinusoidal_positions(T, d, frames.device).to(dtype)

    def run(layers, x):
        for i in layers:
            lp = _layer(p["enc_layers"], i)
            h = nn.layernorm(lp["attn_norm"], x, cfg.norm_eps)
            x = x + attn.gqa_forward(lp["attn"], h, cfg, causal=False, rope=False)
            h = nn.layernorm(lp["mlp_norm"], x, cfg.norm_eps)
            x = x + _ffn(lp["mlp"], h)
        return x, 0.0

    x, _ = remat_groups(run, list(range(cfg.n_encoder_layers)), x, cfg)
    return nn.layernorm(p["enc_norm"], x, cfg.norm_eps)


def _embed_prompt(p, tokens, cfg) -> torch.Tensor:
    S = tokens.shape[1]
    pe = nn.sinusoidal_positions(S, cfg.d_model, tokens.device)[None]
    return nn.embed_lookup(p["embed"], tokens) + pe.to(_dtype(cfg))


def _dec_layer(lp, x, enc, cfg, *, return_cache: bool = False):
    """One decoder block over a whole prompt: (x, self (k, v) or None,
    cross (k, v))."""
    h = nn.layernorm(lp["attn_norm"], x, cfg.norm_eps)
    a = attn.gqa_forward(lp["attn"], h, cfg, causal=True, rope=False, return_cache=return_cache)
    kv = None
    if return_cache:
        a, kv = a
    x = x + a
    h = nn.layernorm(lp["cross_norm"], x, cfg.norm_eps)
    ckv = attn.cross_attn_kv(lp["cross"], enc, cfg)
    x = x + attn.cross_attn(lp["cross"], h, ckv, cfg)
    h = nn.layernorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + _ffn(lp["mlp"], h), kv, ckv


def encdec_forward_features(p, batch, cfg):
    """Teacher-forced trunk: batch ``frames`` (B, T, d) and ``tokens`` (B, S)
    -> (dec_norm'd hidden states (B, S, d), aux 0.0)."""
    tokens = batch["tokens"]
    enc = encdec_encode(p, _frames(batch, tokens.device), cfg)
    x = _embed_prompt(p, tokens, cfg)

    def run(layers, x):
        for i in layers:
            x = _dec_layer(_layer(p["dec_layers"], i), x, enc, cfg)[0]
        return x, 0.0

    x, _ = remat_groups(run, list(range(cfg.n_layers)), x, cfg)
    return nn.layernorm(p["dec_norm"], x, cfg.norm_eps), 0.0


def encdec_head_apply(p, x, cfg) -> torch.Tensor:
    """fp32 logits: the head's product in the model dtype, then cast (the
    reference's ``nn.dense`` then ``astype(float32)``)."""
    return nn.dense(p["lm_head"], x).float()


def encdec_forward(p, batch, cfg):
    x, aux = encdec_forward_features(p, batch, cfg)
    return encdec_head_apply(p, x, cfg), aux


def _cross_cache(cfg, batch_size: int, device) -> dict:
    shape = (cfg.n_layers, batch_size, cfg.n_audio_frames, cfg.n_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=_dtype(cfg), device=device) for n in ("k", "v")}


def encdec_init_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
    return {"self": _stacked_zeros(one, cfg.n_layers, device), "cross_kv": _cross_cache(cfg, batch_size, device)}


def encdec_init_cache_paged(cfg, batch_size: int, max_len: int, *, page_size: int, n_pages: int, device):
    """The decoder's self K/V as page pools (n_pages + 1 with the trash page)
    plus a (batch, max_pages) block table on the trash id; the encoder's
    cross K/V (a fixed n_audio_frames a slot) stays slot-resident.  Returns
    ``(cache, paged_mask)`` (see ``lm.lm_init_cache_paged``)."""
    one, paged = attn.gqa_init_cache_paged(cfg, page_size, n_pages + 1, _dtype(cfg), device)
    if not paged:
        raise ValueError("the whisper decoder's self-attention has no sliding window")
    cache = {"self": _stacked_zeros(one, cfg.n_layers, device), "cross_kv": _cross_cache(cfg, batch_size, device)}
    mask = {"self": {k: True for k in one}, "cross_kv": {k: False for k in cache["cross_kv"]}}
    max_pages = -(-max_len // page_size)
    cache["block_table"] = torch.full((batch_size, max_pages), n_pages, dtype=torch.int32, device=device)
    return cache, mask


@dispatch.prefill_rows()
def encdec_prefill(p, batch, cfg, max_len: int, *, last_index: Optional[torch.Tensor] = None):
    """Encode the frames and run the decoder prompt, building both caches;
    the linears compute prompt rows (``dispatch.prefill_rows``).

    Returns (last_token_logits (B, Vp) fp32, cache).  ``last_index``:
    optional (B,) index of each sequence's last valid prompt token (for
    right-padded micro-batches); by default the last column."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} > max_len {max_len}")
    enc = encdec_encode(p, _frames(batch, tokens.device), cfg)
    cache = encdec_init_cache(cfg, B, max_len, tokens.device)
    x = _embed_prompt(p, tokens, cfg)
    for i in range(cfg.n_layers):
        x, (k, v), (ck, cv) = _dec_layer(_layer(p["dec_layers"], i), x, enc, cfg, return_cache=True)
        cache["self"]["k"][i, :, :S] = k
        cache["self"]["v"][i, :, :S] = v
        cache["cross_kv"]["k"][i] = ck
        cache["cross_kv"]["v"][i] = cv
    x = nn.layernorm(p["dec_norm"], x, cfg.norm_eps)
    if last_index is None:
        last = x[:, -1:]
    else:
        idx = torch.as_tensor(last_index, dtype=torch.int64, device=x.device)
        last = x[torch.arange(B, device=x.device), idx][:, None]
    return encdec_head_apply(p, last, cfg)[:, 0], cache


def encdec_decode_step(p, cache, tokens, pos, cfg):
    """tokens: (B, 1); ``pos``: scalar or (B,) per-slot positions.  A cache
    with a ``block_table`` (``encdec_init_cache_paged``) takes the paged
    decode in self-attention; cross-attention reads the slot's ``cross_kv``
    through the flash kernel at Sq = 1.  The position table spans the
    cache's logical length (the block table's pages x page on the paged
    layout), as the reference's.  Returns (logits (B, Vp) fp32, cache),
    the cache updated in place."""
    B = tokens.shape[0]
    pos_v = attn.position_vector(pos, B, tokens.device)
    bt = cache.get("block_table")
    S_self = cache["self"]["k"].shape[2]  # max_len flat, the page size paged
    pe_len = S_self if bt is None else bt.shape[1] * S_self
    pe = nn.sinusoidal_positions(pe_len, cfg.d_model, tokens.device)
    x = nn.embed_lookup(p["embed"], tokens) + pe[pos_v][:, None].to(_dtype(cfg))
    for i in range(cfg.n_layers):
        lp, c = _layer(p["dec_layers"], i), _layer(cache["self"], i)  # views into the stacked cache
        h = nn.layernorm(lp["attn_norm"], x, cfg.norm_eps)
        if bt is None:
            a, _ = attn.gqa_decode(lp["attn"], h, c, pos_v, cfg)
        else:
            a, _ = attn.gqa_decode_paged(lp["attn"], h, c, pos_v, cfg, bt)
        x = x + a
        h = nn.layernorm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + attn.cross_attn(lp["cross"], h, (cache["cross_kv"]["k"][i], cache["cross_kv"]["v"][i]), cfg)
        h = nn.layernorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + _ffn(lp["mlp"], h)
    x = nn.layernorm(p["dec_norm"], x, cfg.norm_eps)
    return encdec_head_apply(p, x, cfg)[:, 0], cache
