"""Wrapper of the sketch GEMM kernel (``csrc/sketch_matmul.cu``).

``C = op(A) @ B`` with an fp32 accumulator, ``op(A) = A.T`` under
``trans_a`` — RSI's ``W @ Y`` and ``W^T @ X`` read W in place.  Replaces the
TPU kernel ``repro/kernels/sketch_matmul.py::sketch_matmul_pallas``.  The
output is in A's dtype, or fp32 when ``out_dtype=torch.float32`` (the
tied-embedding logits, which the reference keeps unrounded).

On a CPU tensor the plain version (``ref.sketch_matmul_ref``) runs; on a
CUDA tensor the kernel launches or this raises.

The bf16 kernel loads its tiles by TMA, which needs each operand's base and
row stride on 16-byte boundaries.  RSI's operands (``aligned_rows``,
``padded_rows``) and the logits' (``aligned_rows(x.T)``) have them; any
other bf16 operand is first copied into such storage (``aligned_rows``), the
same kernel then runs on the copy, and :data:`ALIGN_COPIES` (shared with
the low-rank kernels' wrappers) counts the copies, so a run can show that
its main path made none.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import ALIGN_COPIES, I, KernelLib, P, padded_rows, row_stride, tma_ready

__all__ = ["KERNEL", "ALIGN_COPIES", "sketch_matmul"]

_ARGS = [P, P, P, I, I, I, I, I, I, I, P]
KERNEL = KernelLib(
    "sketch_matmul",
    {"sketch_matmul_bf16": _ARGS, "sketch_matmul_bf16_f32out": _ARGS, "sketch_matmul_f32": _ARGS},
)


def sketch_matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: (M, K), or the stored (K, M) under ``trans_a``; b: (K, N) -> (M, N).

    The CUDA result may be a row-strided view (row stride padded to a
    multiple of 8 elements), so it feeds the next GEMM with 16-byte loads.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.sketch_matmul_ref(a, b, trans_a=trans_a, out_dtype=out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sketch_matmul: operands on {a.device} and {b.device}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise TypeError(f"sketch_matmul: dtypes {a.dtype}, {b.dtype}; need both bf16 or both fp32")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"sketch_matmul: out_dtype {out_dtype} for {a.dtype} inputs")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"sketch_matmul: 2-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    K, M = a.shape if trans_a else a.shape[::-1]
    if b.shape[0] != K:
        raise ValueError(f"sketch_matmul: op(a) is ({M}, {K}) but b is {tuple(b.shape)}")
    N = b.shape[1]
    if a.dtype == torch.bfloat16:
        a, b = tma_ready(a, "sketch_matmul a"), tma_ready(b, "sketch_matmul b")
    lda, ldb = row_stride(a, "sketch_matmul a"), row_stride(b, "sketch_matmul b")
    c = padded_rows(M, N, out_dtype, a.device)
    if a.dtype == torch.float32:
        entry = "sketch_matmul_f32"
    else:
        entry = "sketch_matmul_bf16_f32out" if out_dtype == torch.float32 else "sketch_matmul_bf16"
    KERNEL.launch(entry, a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  M, N, K, lda, ldb, c.stride(0), int(trans_a))
    return c
