"""Wrapper of the prefill attention kernel (``csrc/flash_attention.cu``).

Causal / sliding-window / ``q_offset`` attention with GQA head grouping and
the numerics of the reference's ``models/attention.py::_flash_fwd_pass``,
at a v head dim equal to q's or, for MLA (deepseek-v2), q/k 192 with v 128.
Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``
and, in the model, the reference's XLA prefill loop.

On a CPU tensor the plain version (``ref.chunked_attention_ref``) runs; on a
CUDA tensor the kernel launches or this raises.  ``return_lse=True`` (the
training forward, ``runtime/dispatch.py``) also returns each row's fp32
log-sum-exp in the reference's ``(B, KV, G, Sq)`` layout, which the
backward reads; the output's bits do not depend on it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, KernelLib, P, check_vector_layout

__all__ = ["KERNEL", "HEAD_DIMS", "HEAD_DIM_PAIRS", "flash_attention"]

HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # head dims the kernel is instantiated for with v's equal to q's
# every (q/k head dim, v head dim) pair it is instantiated for: those, and MLA's q/k 192 with v 128
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)
_ARGS = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P]
KERNEL = KernelLib("flash_attention", {"flash_attention_bf16": _ARGS, "flash_attention_f32": _ARGS})


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                    return_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, vd) -> (B, Sq, H, vd),
    scaled by hd**-0.5; with ``return_lse`` also lse (B, KV, H // KV, Sq) fp32."""
    ts = (q, k, v)
    if all(t.device.type == "cpu" for t in ts):
        if return_lse:
            return ref.flash_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        return ref.chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError(f"flash_attention: operands on {[str(t.device) for t in ts]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    vd = v.shape[-1]
    if H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if k.shape != (B, Skv, KV, hd) or v.shape != (B, Skv, KV, vd):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (hd, vd) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention: head dims (q/k {hd}, v {vd}) not in {HEAD_DIM_PAIRS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: operands must be contiguous")
    if return_lse and Skv == 0:
        raise ValueError("flash_attention: no lse without keys")
    check_vector_layout("flash_attention", q, k, v)
    out = q.new_empty((B, Sq, H, vd))
    lse = torch.empty((B, KV, H // KV, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    entry = "flash_attention_f32" if q.dtype == torch.float32 else "flash_attention_bf16"
    KERNEL.launch(entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV, hd, vd, int(causal),
                  -1 if window is None else int(window), int(q_offset), hd**-0.5)
    return (out, lse) if return_lse else out
