"""Model dispatch: one API over the ported families.

The port's counterpart of ``repro/models/model.py``.  ``build_model(cfg)``
returns a :class:`ModelApi` of functions over a params tree (nested dicts
mirroring the reference's pytree); :class:`LMModule` is the ``nn.Module``
that owns such a tree's tensors.  The ``dense`` family, the ``moe`` family
with GQA attention, and the ``ssm`` (mamba2) and ``hybrid`` (zamba2)
families are ported; any other family raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as lm_mod
from repro_torch.runtime.device import resolve_device

__all__ = ["ModelApi", "LMModule", "build_model", "analytic_param_count"]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # (generator) -> params
    forward: Callable[[Any, dict], tuple]  # (params, batch) -> (logits, aux)
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
    # one page-aligned prefill chunk through the slot's block-table row; None
    # where prefill carries state across the whole prompt (ssm, hybrid: the
    # engine prefills those monolithically)
    prefill_chunk: Any = None


def build_model(cfg: ArchConfig, *, device: Optional[Union[str, torch.device]] = None) -> ModelApi:
    """The model's functions, running on ``device`` (default: the card)."""
    lm_mod._check_family(cfg)  # dense, GQA moe, ssm or hybrid, no sliding window: raises for the rest
    dev = resolve_device(device)
    chunkable = cfg.family in ("dense", "moe") and cfg.sliding_window is None
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda generator: lm_mod.lm_init(generator, cfg, dev),
        forward=lambda p, b: lm_mod.lm_forward(p, b, cfg),
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


def analytic_param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count N of a dense, GQA moe, ssm or hybrid decoder
    (the reference's formula: the linears and the embeddings)."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid") or cfg.kv_lora_rank or cfg.first_dense_layers
            or cfg.n_shared_experts):
        raise NotImplementedError(f"param count of {cfg.name!r} is not yet ported")
    d, V = cfg.d_model, cfg.vocab_padded
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    n = V * d if cfg.tie_embeddings else 2 * V * d
    if cfg.family in ("ssm", "hybrid"):
        din, s, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        n += cfg.n_layers * (2 * d * din + 2 * d * s + d * nh + din * d)
        # the hybrid's shared attention + MLP block, counted once
        return n + (attn + 3 * d * cfg.d_ff if cfg.family == "hybrid" else 0)
    n += cfg.n_layers * attn
    if cfg.family == "dense":
        return n + cfg.n_layers * 3 * d * cfg.d_ff
    return n + cfg.n_layers * (cfg.n_experts * 3 * d * cfg.moe_d_ff + d * cfg.n_experts)
