"""Public kernel entry points, routed through the port's dispatch runtime.

The twin of ``repro/kernels/ops.py``: the stable ``kernels.ops`` import
surface, each function one call of :mod:`repro_torch.runtime.dispatch`,
which picks the hand-written CUDA kernel (on the card under backend
``auto``) or its plain PyTorch version (``reference``, or a CPU tensor).
Pin a backend with::

    from repro_torch.runtime.dispatch import use_dispatch
    with use_dispatch(backend="reference"):  # or "auto"
        y = ops.lowrank_matmul(x, A, B)
"""

from __future__ import annotations

import torch

from repro_torch.runtime import dispatch as _dispatch

__all__ = ["lowrank_matmul", "sketch_matmul", "ssd_scan", "flash_attention", "decode_attention"]


def sketch_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N): RSI's sketch GEMM, fp32 accumulation, in a's dtype."""
    return _dispatch.sketch_matmul(a, b)


def lowrank_matmul(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """y = (x @ A) @ B: the fused low-rank kernel, the batched one for stacked
    factors, or the plain two-GEMM form.  Takes leading batch dims on x, and
    stacked (L, ...) factors with x (L, M..., K)."""
    return _dispatch.lowrank_apply(x, A, B)


def ssd_scan(x, dt, B_in, C_in, A, *, chunk: int = 128):
    """Mamba2's SSD chunked scan: x (B, L, nh, hd) raw, dt (B, L, nh) after
    softplus, B_in/C_in (B, L, s), A (nh,).  Returns (y, final_state).

    The TPU kernel's contract: x̄ = x * dt formed in fp32 and never rounded
    to x's dtype (``round_xbar=False``).  The models round it first, as the
    reference's models do; the two agree in fp32 and differ in bf16.  The
    kernel walks its own 64-step chunks, ``chunk`` sets the plain version's."""
    return _dispatch.ssd_scan(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=False)


def flash_attention(q, k, v, *, causal: bool = True):
    """Forward-only flash attention (the prefill hot path): q (B, Sq, H, hd),
    k/v (B, Skv, KV, hd), GQA by head grouping."""
    return _dispatch.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, valid):
    """One-token GQA attention over a KV cache (the serving decode hot path).

    valid: (B, S) bool strict per-slot mask; fully-masked rows yield zeros."""
    return _dispatch.decode_attention(q, k_cache, v_cache, valid)
