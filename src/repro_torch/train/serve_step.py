"""Serving steps: batched prefill, one decode step, their cache specs, and
batched greedy generation.

The port's counterpart of ``repro/train/serve_step.py``.  ``greedy_generate``
is the reference contract that the continuous-batching engine is held to;
``make_prefill_step`` / ``make_decode_step`` run the model's own under the
sharding rules given, and :func:`cache_specs` lays out a decode cache by
the reference's rules.  Under rules on a live mesh, for the families of
``sharding/rules.py::tensor_parallel``, the steps take this rank's blocks
of the params, return this rank's vocab block of the logits, and the
prefill's cache comes out in :func:`cache_specs`' layout (this rank's rows
and its block of the slots, or every slot where they do not divide over
"model"), which the decode step takes and updates in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.rules import MeshRules, use_rules
from repro_torch.tree import tree_from_paths, tree_paths

__all__ = ["make_prefill_step", "make_decode_step", "cache_specs", "greedy_generate"]


def make_prefill_step(model, *, rules: Optional[MeshRules] = None, max_len: int):
    def prefill_step(params, batch):
        with use_rules(rules):
            return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model, *, rules: Optional[MeshRules] = None):
    def decode_step(params, cache, tokens, pos):
        with use_rules(rules):
            return model.decode_step(params, cache, tokens, pos)

    return decode_step


def cache_specs(cache, rules: MeshRules):
    """The spec tree of a decode cache (nested dicts of tensors), by the
    reference's rules on the leaf's path name and rank:

      SSM state   (L, B, nh, hd, st)  -> (None, batch, tp, None, None)
      conv tails  (L, B, w-1, ch)     -> (None, batch, None, tp)
      cross K/V   (G, B, T, H, hd)    -> (None, batch, None, tp, None)
      KV caches   (L, B, S, KV, hd)   -> (None, batch, tp, None, None): the
                  SEQUENCE over "model" (flash-decode layout), since heads
                  over "model" would gather the cache wherever KV heads are
                  fewer than the axis (GQA)
      MLA latents (L, B, S, lora)     -> (None, batch, tp, None)
      (B, ., .)                       -> (batch, None, None)
      anything else (the paged block table) replicated

    Every assignment is divisibility-guarded.  One layout differs from the
    reference's: a vlm's self-attention K/V is one (n_groups * n_self, B, S,
    KV, hd) stack in the port (``layers/k``), where the reference holds
    (n_groups, n_self, B, S, KV, hd) (``layers/self/k``) -- the two leading
    dims merged, neither sharded, so the port's spec is the reference's
    with one leading None fewer.  The vlm's cross K/V sits at ``cross_kv``
    (the reference's ``layers/cross_kv``); every other family's cache has
    the reference's paths and shapes.
    """

    def leaf_spec(name: str, leaf: torch.Tensor):
        shape, nd = tuple(leaf.shape), leaf.dim()
        if name.endswith("state"):  # (L, B, nh, hd, st) stacked / (B, nh, hd, st)
            if nd == 5:
                return rules.spec((None, "batch", "tp", None, None), shape)
            return rules.spec(("batch", "tp", None, None), shape)
        if name.endswith("conv_x") or name.endswith("conv_B") or name.endswith("conv_C"):
            return rules.spec((None, "batch", None, "tp"), shape)
        if nd == 6:  # the reference's vlm self-KV (G, n_self, B, S, KV, hd)
            return rules.spec((None, None, "batch", "tp", None, None), shape)
        if nd == 5:
            if "cross" in name:  # (G/L, B, T, H, hd)
                return rules.spec((None, "batch", None, "tp", None), shape)
            return rules.spec((None, "batch", "tp", None, None), shape)
        if nd == 4:  # the MLA latent (L, B, S, lora)
            return rules.spec((None, "batch", "tp", None), shape)
        if nd == 3:
            return rules.spec(("batch", None, None), shape)
        return ()

    return tree_from_paths((path, leaf_spec(path, leaf)) for path, leaf in tree_paths(cache))


@torch.no_grad()
def greedy_generate(model, params, batch, *, steps: int, max_len: int) -> torch.Tensor:
    """Greedy-decode ``steps`` tokens per sequence -> (B, steps) int64.

    ``batch["tokens"]``: (B, S) prompt on the model's device.  The decode
    cache is updated in place step by step.
    """
    logits, cache = model.prefill(params, batch, max_len)
    tok = torch.argmax(logits, dim=-1)[:, None]
    start = batch["tokens"].shape[1]
    out = [tok]
    for i in range(steps - 1):
        logits, cache = model.decode_step(params, cache, tok, start + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
