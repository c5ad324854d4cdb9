"""Batched greedy generation: one prefill, then greedy decode steps.

The port's counterpart of ``repro/train/serve_step.py::greedy_generate``,
the reference contract that the continuous-batching engine is held to.
"""

from __future__ import annotations

import torch

__all__ = ["greedy_generate"]


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
