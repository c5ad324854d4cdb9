"""The dense FFN of ``repro/models/moe.py`` (``ffn_init``/``ffn_forward``).

The routed mixture-of-experts layer is not yet ported.
"""

from __future__ import annotations

import torch

from repro_torch.models import modules as nn

__all__ = ["ffn_init", "ffn_forward"]


def ffn_init(generator: torch.Generator, d: int, f: int, dtype, device) -> dict:
    return {
        "w_gate": nn.dense_init(generator, d, f, dtype, device),
        "w_up": nn.dense_init(generator, d, f, dtype, device),
        "w_down": nn.dense_init(generator, f, d, dtype, device, scale=f**-0.5),
    }


def ffn_forward(p, x: torch.Tensor) -> torch.Tensor:
    g = nn.dense(p["w_gate"], x)
    u = nn.dense(p["w_up"], x)
    return nn.dense(p["w_down"], nn.swiglu(g, u))
