"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

One-token GQA attention over a flat cache with a strict per-slot valid
mask; fully-masked rows give zeros.  Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas``.

On a CPU tensor the plain version (``ref.decode_attention_ref``) runs; on a
CUDA tensor the kernel launches or this raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, KernelLib, P, check_vector_layout, Query

__all__ = ["KERNEL", "decode_attention"]

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, F, P]
KERNEL = KernelLib("decode_attention", {
    "decode_attention_bf16": _ARGS,
    "decode_attention_f32": _ARGS,
    "decode_attention_workspace_bytes": Query([I, I, I, I, I], ctypes.c_longlong),
})


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool -> (B, 1, H, vd) in q's dtype."""
    ts = (q, k_cache, v_cache, valid)
    if all(t.device.type == "cpu" for t in ts):
        return ref.decode_attention_ref(q, k_cache, v_cache, valid)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError(f"decode_attention: operands on {[str(t.device) for t in ts]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attention: valid must be bool, got {valid.dtype}")
    B, one, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    vd = v_cache.shape[-1]
    if one != 1:
        raise ValueError(f"decode query must be one token, got q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if k_cache.shape != (B, S, KV, hd) or v_cache.shape[:3] != (B, S, KV) or valid.shape != (B, S):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, valid {tuple(valid.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention: operands must be contiguous")
    check_vector_layout("decode_attention", q, k_cache, v_cache)
    out = torch.empty((B, 1, H, vd), dtype=q.dtype, device=q.device)
    # per-split (m, l, acc) partials, combined by the kernel's second pass
    ws_bytes = KERNEL.query("decode_attention_workspace_bytes", B, S, KV, H // KV, vd)
    ws = torch.empty((max(ws_bytes, 4) // 4,), dtype=torch.float32, device=q.device)
    entry = "decode_attention_f32" if q.dtype == torch.float32 else "decode_attention_bf16"
    KERNEL.launch(entry, q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                  ws.data_ptr(), out.data_ptr(), B, S, KV, H // KV, hd, vd, hd**-0.5)
    return out
