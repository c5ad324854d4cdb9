"""Decoder-only LM, dense, moe, vlm, ssm and hybrid families: init,
forward, prefill and decode.

The port's counterpart of the dense and moe (GQA or MLA attention, routed
and shared experts, dense first layers), vlm (llama-3.2-vision), ssm
(mamba2) and hybrid (zamba2) families of ``repro/models/lm.py``.  The
params tree mirrors the reference's: ``embed``, ``final_norm``, ``lm_head`` where the head is not
tied, and a ``layers`` subtree whose leaves are stacked over layers, shape
(L, ...); a moe layer holds ``moe`` (router, (L, E, ...) expert stacks,
``shared`` experts) where a dense one holds ``mlp``, and a mamba layer
``ssm_in_norm`` and ``mamba``.  A moe model with ``first_dense_layers``
(deepseek-v2) runs a ``dense_layers`` stack of that many blocks first, each
with the model's attention and a dense FFN of width ``dense_d_ff``; its
``layers`` stack holds the other ``n_layers - first_dense_layers``.  MLA
attention (``kv_lora_rank`` set, moe family) holds ``wq_a``, ``q_norm``,
``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo`` in place of
``wq``/``wk``/``wv``/``wo``.  The hybrid family adds ONE unstacked
``shared_attn`` block (attention + MLP) applied after every full segment of
``attn_every`` mamba layers, with tied weights.  The vlm family's
``layers`` holds ``n_layers // cross_attn_every`` groups, as the
reference's: ``layers/self`` stacks ``cross_attn_every - 1`` GQA blocks a
group, shape (n_groups, n_self, ...), and ``layers/cross`` one cross block
a group (``attn_norm``, ``cross``, ``mlp_norm``, ``mlp``), shape (n_groups,
...); each group runs its self blocks, then its cross block over the
request's ``image_embed``.  The reference scans over the layer axis; here
a Python loop takes each layer's slice (a view).

The decode cache is ``{"layers": {"k": (L, B, S, KV, hd), "v": ...}}`` (a
mamba layer: its conv tails and fp32 state, ``models/ssm.py``; an MLA
layer: the latent ``"c_kv": (L, B, S, kv_lora_rank)`` and ``"k_rope": (L,
B, S, qk_rope_dim)``); a ``dense_layers`` stack adds a ``"dense_layers"``
subtree of the same leaves; the hybrid
family's adds ``"shared_attn": {"k": (n_apps, B, S, KV, hd), ...}``, one
cache per application of the shared block.  The vlm family's self blocks
take ``"layers"`` with the groups flattened, (n_groups * n_self, B, S, KV,
hd) (the reference keeps (n_groups, n_self, ...)), and its cross blocks a
``"cross_kv": {"k": (n_groups, B, n_image_tokens, n_heads, hd), "v": ...}``
written once by the prefill and only read by decode.  ``lm_decode_step``
updates the cache IN PLACE: each layer writes its new K/V row (or its
state) into its slice of the stacked tensors.  This replaces the
reference's scan-carry cache (``lm.py:795-822``), whose point was the
same in-place aliasing.  The
paged cache (``lm_init_cache_paged``) holds the K/V leaves as page pools,
``(L, P + 1, page, KV, hd)`` (MLA: ``(L, P + 1, page, kv_lora_rank)`` and
``(L, P + 1, page, qk_rope_dim)``), plus a ``"block_table": (B, n_tbl)``;
the conv tails, states and a vlm's ``cross_kv`` stay slot-resident.  Its
``block_table`` routes ``lm_decode_step``'s attention through the paged
decode, and ``lm_prefill_chunk`` writes one chunk of one slot's prompt
into its pages (dense and moe only: a recurrent state cannot be
prefilled in page-backed chunks, nor a vlm's cross blocks enter
mid-prompt, as in the reference).

Under tensor-parallel rules (``sharding/rules.py``; the dense family and
the moe family without MLA) each rank holds its blocks of the params and
the forward, the prefill and the decode step run on them
(``models/modules.py::TensorParallel``): the embedding and the head are
vocab-parallel, the residual stream's sequence lies over "model" between
blocks where ``"seq"`` is mapped (gathered before the column-parallel
linears, reduce-scattered after the row-parallel ones, the norms on this
rank's rows), the attention and the feed-forward half run on this rank's
heads and columns, and the logits come back as this rank's vocab block.
The decode cache is this rank's block of its slots, split over "model"
as the reference's ``cache_specs`` lay it out: the prefill writes its
slots, a decode step's new row goes to the rank holding its slot, and the
ranks' attentions combine by their log-sum-exp (``models/attention.py``).
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
from repro_torch.sharding.rules import bound_to_rules, leaf_spec, tensor_parallel

__all__ = [
    "lm_init",
    "lm_forward",
    "lm_forward_features",
    "lm_head_apply",
    "lm_init_cache",
    "lm_init_cache_paged",
    "lm_prefill",
    "lm_prefill_chunk",
    "lm_decode_step",
]


_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
# the fields an MLA attention (kv_lora_rank set) needs besides it
_MLA_FIELDS = ("q_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not yet ported (only {', '.join(_FAMILIES)})")
    if _mla(cfg):
        missing = [f for f in _MLA_FIELDS if not getattr(cfg, f)]
        if missing:
            raise ValueError(f"MLA attention (kv_lora_rank={cfg.kv_lora_rank}) needs {', '.join(missing)}")
    if _n_dense_first(cfg) and not (cfg.dense_d_ff or cfg.d_ff):
        raise ValueError(f"first_dense_layers={cfg.first_dense_layers} needs dense_d_ff or d_ff")
    if cfg.family == "vlm" and not (cfg.cross_attn_every >= 2 and cfg.n_image_tokens > 0
                                    and cfg.n_layers >= cfg.cross_attn_every):
        raise ValueError(f"vlm needs cross_attn_every >= 2 (got {cfg.cross_attn_every}), n_image_tokens > 0 "
                         f"(got {cfg.n_image_tokens}) and n_layers >= cross_attn_every (got {cfg.n_layers})")


def _mla(cfg) -> bool:
    """MLA attention: the moe family with a latent KV rank (the reference's rule)."""
    return cfg.family == "moe" and bool(cfg.kv_lora_rank)


def _n_dense_first(cfg) -> int:
    """Blocks of the ``dense_layers`` stack (moe only), run before ``layers``."""
    return cfg.first_dense_layers if cfg.family == "moe" else 0


def _cache_names(cfg) -> tuple:
    """An attention block's cache leaves, in the order its prefill returns them."""
    return ("c_kv", "k_rope") if _mla(cfg) else ("k", "v")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(stack, i: int):
    """Layer ``i``'s slice of a stacked params (or cache) subtree."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _block_init(generator, cfg, dtype, device, *, layer_kind: str) -> dict:
    """One block: ``mamba`` (norm + Mamba2), or attention (MLA under
    :func:`_mla`, else GQA; ``cross``: cross-attention under ``"cross"``)
    with a routed (``moe``) or dense feed-forward half: ``gqa``'s and
    ``cross``'s of width ``d_ff``, ``dense_ffn``'s of ``dense_d_ff``."""
    if layer_kind == "mamba":
        return {"ssm_in_norm": nn.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm_mod.mamba2_init(generator, cfg, dtype, device)}
    p = {"attn_norm": nn.rmsnorm_init(cfg.d_model, dtype, device)}
    if layer_kind == "cross":
        p["cross"] = attn.cross_attn_init(generator, cfg, dtype, device)
    else:
        p["attn"] = (attn.mla_init if _mla(cfg) else attn.gqa_init)(generator, cfg, dtype, device)
    p["mlp_norm"] = nn.rmsnorm_init(cfg.d_model, dtype, device)
    if layer_kind == "moe":
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    else:
        f = cfg.dense_d_ff if (layer_kind == "dense_ffn" and cfg.dense_d_ff) else cfg.d_ff
        p["mlp"] = moe_mod.ffn_init(generator, cfg.d_model, f, dtype, device)
    return p


def _layer_kind(cfg) -> str:
    """The kind of every stacked layer of the family."""
    return {"dense": "gqa", "moe": "moe", "vlm": "gqa", "ssm": "mamba", "hybrid": "mamba"}[cfg.family]


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


# the cache subtree of each kind of block in a schedule (but for a vlm, its params subtree too)
_SUB = {"dense": "dense_layers", "layer": "layers", "shared": "shared_attn", "cross": "cross_kv"}


def _vlm_groups(cfg) -> tuple:
    """(n_groups, self blocks a group) of the vlm family."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _schedule(cfg):
    """The blocks in the order the trunk runs them: ("dense", i) for block i
    of the ``dense_layers`` stack, then ("layer", i) for stacked layer i,
    and (hybrid) ("shared", j) for the shared block's j-th application,
    with its own cache entry j.  A vlm's group g runs ("layer", g * n_self
    + s) for its self blocks s, then ("cross", g)."""
    if cfg.family == "vlm":
        n_groups, n_self = _vlm_groups(cfg)
        return [e for g in range(n_groups)
                for e in [("layer", g * n_self + s) for s in range(n_self)] + [("cross", g)]]
    if cfg.family != "hybrid":
        n0 = _n_dense_first(cfg)
        return [("dense", i) for i in range(n0)] + [("layer", i) for i in range(cfg.n_layers - n0)]
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


def _n_stacked(cfg) -> int:
    """Blocks of the ``layers`` stack (and of its cache)."""
    return sum(1 for kind, _ in _schedule(cfg) if kind == "layer")


def _block(p, kind: str, i: int):
    """The params of scheduled block (kind, i): a slice (views) of its stack
    (a vlm's self block i of the flattened groups, or its group i's cross
    block), or the hybrid's one unstacked shared block."""
    if kind == "shared":
        return p["shared_attn"]
    if "self" in p["layers"]:  # vlm: a group's self block, or its cross block
        if kind == "cross":
            return _layer(p["layers"]["cross"], i)
        n_self = p["layers"]["self"]["attn_norm"]["scale"].shape[1]
        return _layer(_layer(p["layers"]["self"], i // n_self), i % n_self)
    return _layer(p[_SUB[kind]], i)


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
    n0 = _n_dense_first(cfg)
    if n0:
        p["dense_layers"] = _stack([_block_init(generator, cfg, dtype, device, layer_kind="dense_ffn")
                                    for _ in range(n0)])
    if cfg.family == "vlm":
        n_groups, n_self = _vlm_groups(cfg)
        p["layers"] = _stack([{"self": _stack([_block_init(generator, cfg, dtype, device, layer_kind="gqa")
                                               for _ in range(n_self)]),
                               "cross": _block_init(generator, cfg, dtype, device, layer_kind="cross")}
                              for _ in range(n_groups)])
        return p
    p["layers"] = _stack([_block_init(generator, cfg, dtype, device, layer_kind=kind)
                          for _ in range(cfg.n_layers - n0)])
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_init(generator, cfg, dtype, device, layer_kind="gqa")
    return p


def _tp(cfg, seq_len: Optional[int] = None):
    """The forward's tensor-parallel layout where the rules and the family run it, else None."""
    return nn.tensor_parallel(seq_len) if tensor_parallel(cfg) else None


def _head_name(cfg) -> tuple:
    """(leaf, whole shape) of the head: the tied embedding or the untied head."""
    if cfg.tie_embeddings:
        return "embed", (cfg.vocab_padded, cfg.d_model)
    return "lm_head", (cfg.d_model, cfg.vocab_padded)


def lm_head_params(p, cfg) -> dict:
    """``p`` with the head's dense table gathered over "data" once (the
    training step's chunks then share it); ``p`` itself outside
    tensor-parallel rules."""
    tp = _tp(cfg)
    name, _ = _head_name(cfg)
    if tp is None or lowrank.is_lowrank(p[name]):
        return p
    return {**p, name: _head_table(p, cfg, tp)}


def _head_spec(cfg) -> tuple:
    """The head leaf's spec; raises where the vocab does not split over
    "model" (the program has no fallback for it, ``sharding/rules.py``)."""
    name, shape = _head_name(cfg)
    spec = leaf_spec(name, shape)
    if spec[0 if name == "embed" else 1] != "model":
        raise ValueError(f"the tensor-parallel head needs the padded vocab {cfg.vocab_padded} to divide "
                         "over \"model\"")
    return spec


def _head_table(p, cfg, tp):
    """The head's dense table on this rank: its vocab block, every ``d``
    column (gathered over "data" unless :func:`lm_head_params` did)."""
    name, shape = _head_name(cfg)
    w, spec = p[name], _head_spec(cfg)
    d_dim = 1 if name == "embed" else 0
    if w.shape[d_dim] == cfg.d_model:  # already gathered
        return w
    return lowrank.gather_blocks(w, spec, tp.mesh)


def _logits(p, x, cfg, tp=None) -> torch.Tensor:
    """fp32 logits (``repro/models/lm.py::_logits``).  The tied embedding and
    a dense untied head give fp32-accumulated logits never rounded to the
    model dtype; a compressed head goes through ``nn.dense`` like any
    factored linear, so its logits ARE rounded to the model dtype first and
    then cast to fp32, as the reference's are.  Under ``tp`` the rows x are
    whole and the logits this rank's vocab block."""
    if tp is not None:
        name, shape = _head_name(cfg)
        if lowrank.is_lowrank(p[name]):
            _head_spec(cfg)
            return nn.tp_linear(tp, p[name], x, name, shape).float()
        return dispatch.logits_apply(x, _head_table(p, cfg, tp), tied=cfg.tie_embeddings)
    if cfg.tie_embeddings:
        return dispatch.logits_apply(x, p["embed"])
    head = p["lm_head"]
    if lowrank.is_lowrank(head):
        return nn.dense(head, x).float()
    return dispatch.logits_apply(x, head, tied=False)


def _mlp(lp, h, cfg, *, with_aux: bool = False, tp=None):
    """The block's feed-forward half: routed experts or the dense FFN.
    Returns (out, aux loss).  The aux loss is computed only ``with_aux``
    (lm_forward reads it; the serving paths skip its kernels) and is 0.0
    otherwise and for a dense model."""
    if "moe" not in lp:
        return moe_mod.ffn_forward(lp["mlp"], h, tp=tp, d_ff=cfg.d_ff), 0.0
    if with_aux:
        return moe_mod.moe_forward(lp["moe"], h, cfg, tp=tp)
    return moe_mod.moe_apply(lp["moe"], h, cfg, tp=tp), 0.0


def _self_block(lp, x, cfg, positions, *, return_cache: bool = False, tp=None):
    """An attention block over a whole sequence; with ``return_cache`` also
    its cache rows, in :func:`_cache_names` order."""
    h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps, tp)
    kw = {} if tp is None else {"tp": tp}
    forward = attn.mla_forward if _mla(cfg) else attn.gqa_forward
    a = forward(lp["attn"], h, cfg, positions=positions, return_cache=return_cache, **kw)
    kv = None
    if return_cache:
        a, kv = a
    x = x + a
    h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps, tp)
    m, aux = _mlp(lp, h, cfg, with_aux=not return_cache, tp=tp)  # return_cache: the serving prefill
    return x + m, kv, aux


def _cross_block(lp, x, kv, cfg):
    """A vlm cross block: cross-attention over the image's (k, v), then the
    SwiGLU feed-forward half (``repro/models/lm.py::_cross_block``)."""
    h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    x = x + attn.cross_attn(lp["cross"], h, kv, cfg)
    h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + moe_mod.ffn_forward(lp["mlp"], h)


def _image(batch, x) -> torch.Tensor:
    """A vlm batch's ``image_embed`` (B, n_image_tokens, d) in the model's
    dtype, on the tokens' device."""
    if "image_embed" not in batch:
        raise ValueError("a vlm batch needs 'image_embed' (B, n_image_tokens, d_model)")
    return torch.as_tensor(batch["image_embed"], device=x.device).to(x.dtype)


def _mamba_block(lp, x, cfg, *, return_cache: bool = False):
    h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
    if not return_cache:
        return x + ssm_mod.mamba2_forward(lp["mamba"], h, cfg), None
    o, c = ssm_mod.mamba2_forward(lp["mamba"], h, cfg, return_cache=True)
    return x + o, c


def remat_groups(run, entries: list, x, cfg):
    """``run(entries, x) -> (x, aux)`` over the trunk's blocks.  In a training
    forward (grad mode on, ``cfg.remat == "block"``) each group of
    ``cfg.remat_group`` consecutive blocks runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept for
    the backward, which re-runs the group, the memory schedule of the
    reference's custom-VJP scan (``repro/models/lm.py::_scan_blocks``) with
    the same numerics; each group sums its aux from zero, as there."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return run(entries, x)
    from torch.utils.checkpoint import checkpoint

    g = max(1, cfg.remat_group)
    aux = 0.0
    # the recomputation in the backward takes the forward's paths and sharding rules
    run = bound_to_rules(dispatch.bound_to_dispatch(run))
    for j in range(0, len(entries), g):
        x, a = checkpoint(run, entries[j:j + g], x, use_reentrant=False)
        aux = aux + a
    return x, aux


def lm_forward_features(p, batch, cfg):
    """The trunk: batch['tokens'] (B, S) -> (final-norm hidden states (B, S,
    d), aux_loss): the sum of the moe layers' load-balance losses (0.0 for
    any other family).  A vlm batch also holds ``image_embed`` (B,
    n_image_tokens, d).  The training step applies the head per sequence
    chunk (``train/train_step.py::chunked_softmax_xent``)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    tp = _tp(cfg, S)
    x = nn.embed_lookup(p["embed"], tokens, tp, (cfg.vocab_padded, cfg.d_model))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    mamba = _layer_kind(cfg) == "mamba"
    img = _image(batch, x) if cfg.family == "vlm" else None

    def run(entries, x):
        aux = 0.0
        for kind, i in entries:
            if kind == "cross":
                lp = _block(p, kind, i)
                x = _cross_block(lp, x, attn.cross_attn_kv(lp["cross"], img, cfg), cfg)
            elif kind == "layer" and mamba:
                x, _ = _mamba_block(_layer(p["layers"], i), x, cfg)
            else:
                x, _, a = _self_block(_block(p, kind, i), x, cfg, positions, tp=tp)
                aux = aux + a
        return x, aux

    x, aux = remat_groups(run, _schedule(cfg), x, cfg)
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps, tp)
    # under tp: every row, on every rank, for the vocab-parallel head
    return (x if tp is None else tp.enter(x)), aux


def lm_head_apply(p, x, cfg) -> torch.Tensor:
    """fp32 logits of hidden states x (..., d) (under tensor-parallel
    rules: every row, this rank's vocab block)."""
    return _logits(p, x, cfg, _tp(cfg))


def lm_forward(p, batch, cfg):
    """batch['tokens']: (B, S) -> (logits fp32 (B, S, Vp), aux_loss)
    (:func:`lm_forward_features`, then the head)."""
    x, aux = lm_forward_features(p, batch, cfg)
    return _logits(p, x, cfg, _tp(cfg)), aux


def _stacked_zeros(one: dict, n: int, device) -> dict:
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=device) for k, v in one.items()}


def _slots(cfg, max_len: int) -> int:
    """A decode cache's slots a row: ``max_len``, or a sliding window's ring."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window is not None else max_len


def _attn_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    if _mla(cfg):
        return attn.mla_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
    return attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device, tp=_tp(cfg))


def _cross_kv_cache(cfg, batch_size: int, device) -> dict:
    """A vlm's slot-resident cross K/V, (n_groups, B, n_image_tokens, n_heads, hd)."""
    shape = (_vlm_groups(cfg)[0], batch_size, cfg.n_image_tokens, cfg.n_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=_dtype(cfg), device=device) for n in ("k", "v")}


def lm_init_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    _check_family(cfg)
    if _layer_kind(cfg) == "mamba":
        one = ssm_mod.mamba2_init_cache(cfg, batch_size, _dtype(cfg), device)
    else:
        one = _attn_cache(cfg, batch_size, max_len, device)
    n0 = _n_dense_first(cfg)
    cache = {"layers": _stacked_zeros(one, _n_stacked(cfg), device)}
    if cfg.family == "vlm":
        cache["cross_kv"] = _cross_kv_cache(cfg, batch_size, device)
    if n0:
        cache["dense_layers"] = _stacked_zeros(one, n0, device)
    if cfg.family == "hybrid":
        one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
        cache["shared_attn"] = _stacked_zeros(one, _n_shared_apps(cfg), device)
    if _tp(cfg) is not None:
        # the whole cache's slot count, in the shape of an empty leaf: a rank's block alone does not tell
        # a split cache from one kept whole (attention.cache_block)
        cache["slots"] = torch.empty((0, _slots(cfg, max_len)), dtype=torch.int32, device=device)
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
    dense and moe families, a moe model's ``dense_layers`` and MLA's latent
    ``c_kv`` / ``k_rope``, the hybrid's ``shared_attn``, a vlm's self
    blocks), the slot row for the mamba layers' conv tails and states,
    which are O(1) per slot (``False``, as in ``repro/models/lm.py:392-395``),
    and so does a sliding-window arch's ring (``repro/models/lm.py:398-400``)
    and a vlm's ``cross_kv``, a fixed n_image_tokens a slot
    (``repro/models/lm.py:443-461``).  A mamba2
    or h2o-danube cache has no paged leaf at all.
    """
    _check_family(cfg)
    n_phys = n_pages + 1

    def kv_cache():
        init = attn.mla_init_cache_paged if _mla(cfg) else attn.gqa_init_cache_paged
        one, paged = init(cfg, page_size, n_phys, _dtype(cfg), device)
        if not paged:  # the sliding-window ring stays slot-resident
            one = attn.gqa_init_cache(cfg, batch_size, max_len, _dtype(cfg), device)
        return one, paged

    if _layer_kind(cfg) == "mamba":
        one, paged = ssm_mod.mamba2_init_cache(cfg, batch_size, _dtype(cfg), device), False
    else:
        one, paged = kv_cache()
    n0 = _n_dense_first(cfg)
    cache = {"layers": _stacked_zeros(one, _n_stacked(cfg), device)}
    mask = {"layers": {k: paged for k in one}}
    if cfg.family == "vlm":
        cache["cross_kv"] = _cross_kv_cache(cfg, batch_size, device)
        mask["cross_kv"] = {k: False for k in cache["cross_kv"]}
    if n0:
        cache["dense_layers"] = _stacked_zeros(one, n0, device)
        mask["dense_layers"] = {k: paged for k in one}
    if cfg.family == "hybrid":
        kv, kv_paged = kv_cache()
        cache["shared_attn"] = _stacked_zeros(kv, _n_shared_apps(cfg), device)
        mask["shared_attn"] = {k: kv_paged for k in kv}
    max_pages = -(-max_len // page_size)
    cache["block_table"] = torch.full((batch_size, max_pages), n_pages, dtype=torch.int32, device=device)
    return cache, mask


@dispatch.prefill_rows()
def lm_prefill(p, batch, cfg, max_len: int, *, last_index: Optional[torch.Tensor] = None):
    """Run the prompt through the model, building the decode cache.  Its
    linears compute prompt rows (``dispatch.prefill_rows``): a row's bits do
    not depend on the other rows of the batch.

    Returns (last_token_logits (B, Vp) fp32, cache).  ``last_index``:
    optional (B,) index of each sequence's last valid prompt token (for
    right-padded micro-batches); by default the last column.  A
    sliding-window arch's prompt may be longer than its ring
    (``min(max_len, W)`` slots): the ring then holds the prompt's last W
    positions, position p in slot p % W.  A vlm's cross blocks write their
    image's K/V into ``cross_kv``, where every decode step reads it.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} > max_len {max_len}")
    cache = lm_init_cache(cfg, B, max_len, tokens.device)
    tp = _tp(cfg, S)
    x = nn.embed_lookup(p["embed"], tokens, tp, (cfg.vocab_padded, cfg.d_model))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    mamba = _layer_kind(cfg) == "mamba"
    img = _image(batch, x) if cfg.family == "vlm" else None
    for kind, i in _schedule(cfg):
        if kind == "cross":
            lp = _block(p, kind, i)
            k, v = attn.cross_attn_kv(lp["cross"], img, cfg)
            cache["cross_kv"]["k"][i] = k
            cache["cross_kv"]["v"][i] = v
            x = _cross_block(lp, x, (k, v), cfg)
            continue
        if kind == "layer" and mamba:
            x, c = _mamba_block(_layer(p["layers"], i), x, cfg, return_cache=True)
            for name, t in c.items():
                cache["layers"][name][i] = t
            continue
        # an attention block: a stacked layer, a dense first layer, or the
        # hybrid's shared block with its own cache per application
        x, rows, _ = _self_block(_block(p, kind, i), x, cfg, positions, return_cache=True, tp=tp)
        for name, t in zip(_cache_names(cfg), rows):
            dst = cache[_SUB[kind]][name][i]
            lo = attn.cache_block(_slots(cfg, max_len), tp)[0]
            t = t[:, lo:lo + dst.shape[1]]  # this rank's slots of S, or of the ring's W of a longer prompt
            dst[:, :t.shape[1]] = t
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps, tp)
    if tp is not None:
        x = tp.whole(x)
    if last_index is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_index, dtype=torch.int64, device=x.device)
        last = x[torch.arange(B, device=x.device), idx][:, None, :]
    return _logits(p, last, cfg, tp)[:, 0], cache


@dispatch.prefill_rows()
def lm_prefill_chunk(p, cache, tokens, cfg, *, bt_row, start: int, n_real: int):
    """One chunk of one slot's prompt prefill (paged cache only), its linears
    on prompt rows like the monolithic prefill's.

    tokens: (1, C) — the chunk at absolute positions ``start + [0, C)``.
    ``start`` may be any position: page-aligned for a prompt's own chunks,
    mid-page where a shared prefix re-enters (the copy-on-write fork at
    ``L - 1``) or a finished request's reply is rewritten from its prompt's
    end.  The chunk is right-padded when fewer than C real tokens remain
    (``n_real`` are real; padded rows write to the trash page).  ``bt_row``:
    the slot's (n_tbl,) page ids, passed EXPLICITLY rather than read from
    ``cache["block_table"]``: the engine keeps the slot's table row on
    trash until the last chunk lands, so the decode block's frozen-slot
    re-feeds cannot write into a half-prefilled slot's pages.

    Each layer writes the chunk's K/V (MLA: its latent rows) into the
    slot's pages, then attends over the gathered logical cache with an
    absolute-position causal mask, so chunk after chunk computes what the
    monolithic prefill computes (MLA: in latent space, the reference's
    absorbed path, not the flash kernel's).
    Returns ``(last_logits (1, Vp) fp32, cache)``, the logits taken at the
    chunk's last REAL token; the pools are updated in place.  The dense and
    moe families only, without a sliding window: an ssm or hybrid prefill
    carries recurrent state across the whole prompt, and a ring is not paged.
    """
    _check_family(cfg)
    if cfg.family not in ("dense", "moe") or cfg.sliding_window is not None:
        raise ValueError(f"chunked prefill unsupported for family {cfg.family!r}, sliding window "
                         f"{cfg.sliding_window}")
    B, C = tokens.shape
    bt_row = bt_row.reshape(-1)
    x = nn.embed_lookup(p["embed"], tokens)
    chunk = attn.mla_prefill_chunk if _mla(cfg) else attn.gqa_prefill_chunk
    for kind, i in _schedule(cfg):
        lp = _block(p, kind, i)
        c = _layer(cache[_SUB[kind]], i)  # views into the stacked pools
        h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        a, _ = chunk(lp["attn"], h, c, cfg, bt_row, start, n_real)
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
    decode in every attention block but a sliding-window arch's, whose ring
    is a slot row; the mamba layers' conv tails and states, and a vlm's
    ``cross_kv``, are slot rows either way."""
    _check_family(cfg)
    tp = _tp(cfg)
    x = nn.embed_lookup(p["embed"], tokens, tp, (cfg.vocab_padded, cfg.d_model))
    pos_v = attn.position_vector(pos, tokens.shape[0], tokens.device)  # once per step, on the device
    bt = cache.get("block_table") if cfg.sliding_window is None else None
    mamba = _layer_kind(cfg) == "mamba"
    mla = _mla(cfg)
    for kind, i in _schedule(cfg):
        if kind == "cross":
            x = _cross_block(_block(p, kind, i), x, (cache["cross_kv"]["k"][i], cache["cross_kv"]["v"][i]), cfg)
            continue
        if kind == "layer" and mamba:
            lp = _layer(p["layers"], i)
            h = nn.rmsnorm(lp["ssm_in_norm"], x, cfg.norm_eps)
            x = x + ssm_mod.mamba2_decode(lp["mamba"], h, _layer(cache["layers"], i), cfg)[0]
            continue
        lp, c = _block(p, kind, i), _layer(cache[_SUB[kind]], i)  # views into the stacked cache
        h = nn.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        if bt is not None:
            decode = attn.mla_decode_paged if mla else attn.gqa_decode_paged
            a, _ = decode(lp["attn"], h, c, pos_v, cfg, bt)
        elif tp is not None:
            a, _ = attn.gqa_decode(lp["attn"], h, c, pos_v, cfg, tp, cache["slots"].shape[1])
        else:
            a, _ = (attn.mla_decode if mla else attn.gqa_decode)(lp["attn"], h, c, pos_v, cfg)
        x = x + a
        h = nn.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + _mlp(lp, h, cfg, tp=tp)[0]
    x = nn.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, x, cfg, tp)[:, 0], cache
