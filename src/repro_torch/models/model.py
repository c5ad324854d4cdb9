"""Model dispatch: one API over the ported families.

The port's counterpart of ``repro/models/model.py``.  ``build_model(cfg)``
returns a :class:`ModelApi` of functions over a params tree (nested dicts
mirroring the reference's pytree); :class:`LMModule` is the ``nn.Module``
that owns such a tree's tensors.  Every family of the reference is ported:
``dense`` (with or without a sliding window), ``moe`` (GQA or MLA
attention, dense first layers, shared experts), ``vlm`` (cross-attention
image layers), ``ssm`` (mamba2) and ``hybrid`` (zamba2) through
``models/lm.py``, and ``audio`` (whisper's encoder-decoder) through
``models/encdec.py``.  A vlm batch carries ``image_embed`` and an audio
batch ``frames`` beside its ``tokens``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ed_mod
from repro_torch.models import lm as lm_mod
from repro_torch.runtime.device import resolve_device

__all__ = ["ModelApi", "LMModule", "build_model", "batch_spec_template", "analytic_param_count"]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # (generator) -> params
    forward: Callable[[Any, dict], tuple]  # (params, batch) -> (logits, aux)
    # (params, batch) -> (final-norm hidden states (B, S, d), aux), then
    # (params, x) -> fp32 logits: the chunked-loss training path's halves
    forward_features: Callable[[Any, dict], tuple]
    head_apply: Callable[[Any, torch.Tensor], torch.Tensor]
    init_cache: Callable[[int, int], Any]  # (batch, max_len) -> cache
    # (params, batch, max_len, *, last_index=None) -> (last logits, cache)
    prefill: Callable[..., tuple]
    # (params, cache, tokens, pos) -> (logits, cache); the cache is updated in place.
    # A cache from init_cache_paged (block_table leaf) takes the paged decode.
    decode_step: Callable[[Any, Any, torch.Tensor, Any], tuple]
    # (batch, max_len, page_size, n_pages) -> (paged cache, paged_mask): page
    # pools plus a block table, for the paged serving engine
    init_cache_paged: Any = None
    # (params, cache, tokens (1, C), bt_row, start, n_real) -> (logits, cache):
    # one prefill chunk at any start (page-aligned, or mid-page where a shared
    # prefix re-enters) through the slot's block-table row; None
    # where prefill carries state across the whole prompt (ssm, hybrid), the
    # cache is a sliding window's ring, or the prompt attends a per-request
    # context (vlm, audio): the engine prefills those monolithically
    prefill_chunk: Any = None
    # (params) -> params with the head's blocks gathered once for a training
    # step's loss chunks (tensor-parallel rules); None: the params as they are
    head_params: Any = None


def build_model(cfg: ArchConfig, *, device: Optional[Union[str, torch.device]] = None) -> ModelApi:
    """The model's functions, running on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        return ModelApi(
            cfg=cfg,
            device=dev,
            init=lambda generator: ed_mod.encdec_init(generator, cfg, dev),
            forward=lambda p, b: ed_mod.encdec_forward(p, b, cfg),
            forward_features=lambda p, b: ed_mod.encdec_forward_features(p, b, cfg),
            head_apply=lambda p, x: ed_mod.encdec_head_apply(p, x, cfg),
            init_cache=lambda bs, ml: ed_mod.encdec_init_cache(cfg, bs, ml, dev),
            prefill=lambda p, b, ml, **kw: ed_mod.encdec_prefill(p, b, cfg, ml, **kw),
            decode_step=lambda p, c, t, pos: ed_mod.encdec_decode_step(p, c, t, pos, cfg),
            init_cache_paged=lambda bs, ml, ps, npg: ed_mod.encdec_init_cache_paged(
                cfg, bs, ml, page_size=ps, n_pages=npg, device=dev),
        )
    lm_mod._check_family(cfg)  # raises for an unknown family
    # a chunk enters mid-prompt through the pages: not for recurrent state, nor for a
    # sliding window's ring (the reference's gate, repro/models/lm.py:690)
    chunkable = cfg.family in ("dense", "moe") and cfg.sliding_window is None
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda generator: lm_mod.lm_init(generator, cfg, dev),
        forward=lambda p, b: lm_mod.lm_forward(p, b, cfg),
        forward_features=lambda p, b: lm_mod.lm_forward_features(p, b, cfg),
        head_apply=lambda p, x: lm_mod.lm_head_apply(p, x, cfg),
        head_params=lambda p: lm_mod.lm_head_params(p, cfg),
        init_cache=lambda bs, ml: lm_mod.lm_init_cache(cfg, bs, ml, dev),
        prefill=lambda p, b, ml, **kw: lm_mod.lm_prefill(p, b, cfg, ml, **kw),
        decode_step=lambda p, c, t, pos: lm_mod.lm_decode_step(p, c, t, pos, cfg),
        init_cache_paged=lambda bs, ml, ps, npg: lm_mod.lm_init_cache_paged(
            cfg, bs, ml, page_size=ps, n_pages=npg, device=dev),
        prefill_chunk=(
            (lambda p, c, t, bt_row, start, n_real: lm_mod.lm_prefill_chunk(
                p, c, t, cfg, bt_row=bt_row, start=start, n_real=n_real))
            if chunkable else None
        ),
    )


class LMModule(torch.nn.Module):
    """Owns a params tree's tensors as buffers (no autograd state).

    Buffer names are the tree paths with '/' replaced by '__', so
    ``state_dict()`` round-trips; :meth:`params` rebuilds the nested tree
    (views of the same tensors) for the functional API.
    """

    def __init__(self, model: ModelApi, params: Mapping):
        super().__init__()
        self.model = model
        self._paths = []
        for path, t in _flatten(params):
            name = path.replace("/", "__")
            self.register_buffer(name, t, persistent=True)
            self._paths.append((path, name))

    def params(self) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            keys = path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = getattr(self, name)
        return tree

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, _ = self.model.forward(self.params(), {"tokens": tokens})
        return logits


def _flatten(tree: Mapping, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def batch_spec_template(cfg: ArchConfig, batch: int, seq: int, *, kind: str) -> dict:
    """Shapes and dtypes of one batch, as (shape, dtype) tuples: the
    reference's template (``repro/models/model.py::batch_spec_template``)
    with torch dtypes.  ``kind``: train | prefill | decode."""
    d = {}
    if cfg.family == "audio":
        d["frames"] = ((batch, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        d["image_embed"] = ((batch, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    if kind == "decode":
        d["tokens"] = ((batch, 1), torch.int32)
    else:
        d["tokens"] = ((batch, seq), torch.int32)
        if kind == "train":
            d["targets"] = ((batch, seq), torch.int32)
    return d


def analytic_param_count(cfg: ArchConfig, *, active_only: bool = False) -> int:
    """Analytic parameter count N of any family: the reference's formula
    (``repro/models/model.py::analytic_param_count``), the linears and the
    embeddings (norm scales and biases not counted).  ``active_only``: an
    MoE layer counts its top-k routed experts, not all of them (the N of
    MODEL_FLOPS = 6 N D)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")
    d, V = cfg.d_model, cfg.vocab_padded
    if cfg.kv_lora_rank:  # MLA
        H, lq, lkv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        attn = d * lq + lq * H * (nope + rd) + d * (lkv + rd) + lkv * H * (nope + vd) + H * vd * d
    else:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    n = V * d if cfg.tie_embeddings else 2 * V * d
    if cfg.family in ("ssm", "hybrid"):
        din, s, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        n += cfg.n_layers * (2 * d * din + 2 * d * s + d * nh + din * d)
        # the hybrid's shared attention + MLP block, counted once
        return n + (attn + 3 * d * cfg.d_ff if cfg.family == "hybrid" else 0)
    Hhd = cfg.n_heads * cfg.head_dim
    if cfg.family == "vlm":  # n_groups x (n_self GQA blocks + one cross block), SwiGLU FFNs
        n_groups = cfg.n_layers // cfg.cross_attn_every
        n_self = n_groups * (cfg.cross_attn_every - 1)
        return n + n_self * (attn + 3 * d * cfg.d_ff) + n_groups * (4 * d * Hhd + 3 * d * cfg.d_ff)
    if cfg.family == "audio":  # encoder blocks, then decoder blocks with cross-attention; GELU FFNs
        return (n + cfg.n_encoder_layers * (attn + 2 * d * cfg.d_ff)
                + cfg.n_layers * (attn + 4 * d * Hhd + 2 * d * cfg.d_ff))
    n += cfg.n_layers * attn
    if cfg.family == "dense":
        return n + cfg.n_layers * 3 * d * cfg.d_ff
    n += cfg.first_dense_layers * 3 * d * (cfg.dense_d_ff or cfg.d_ff)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    experts = cfg.top_k if active_only else cfg.n_experts
    return n + n_moe * ((experts + cfg.n_shared_experts) * 3 * d * cfg.moe_d_ff + d * cfg.n_experts)
