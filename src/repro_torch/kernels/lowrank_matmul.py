"""Wrapper of the low-rank linear kernel (``csrc/lowrank_matmul.cu``).

``y = (x @ A) @ B``: the ``(x @ A)`` intermediate accumulates in fp32 and is
rounded to x's dtype before ``@ B``.  Replaces the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas``.  Every rank is
accepted: there is no residency budget to fit, unlike the TPU kernel's VMEM
check.

On a CPU tensor the plain version (``ref.lowrank_matmul_ref``) runs; on a
CUDA tensor the kernel launches or this raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, KernelLib, P, Query, padded_rows, row_stride

__all__ = ["KERNEL", "lowrank_matmul"]

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
KERNEL = KernelLib("lowrank_matmul", {
    "lowrank_matmul_bf16": _ARGS,
    "lowrank_matmul_f32": _ARGS,
    "lowrank_matmul_workspace_bytes": Query([I, I, I, I, I], ctypes.c_longlong),
})


def lowrank_matmul(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x: (M, K); A: (K, r); B: (r, N) -> (M, N) in x's dtype."""
    devs = {x.device.type, A.device.type, B.device.type}
    if devs == {"cpu"}:
        return ref.lowrank_matmul_ref(x, A, B)
    if devs != {"cuda"} or not (x.device == A.device == B.device):
        raise ValueError(f"lowrank_matmul: operands on {x.device}, {A.device}, {B.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not (x.dtype == A.dtype == B.dtype):
        raise TypeError(f"lowrank_matmul: dtypes {x.dtype}, {A.dtype}, {B.dtype}; need one of bf16/fp32")
    if x.dim() != 2 or A.dim() != 2 or B.dim() != 2:
        raise ValueError(f"lowrank_matmul: 2-D operands, got x {tuple(x.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    M, K = x.shape
    r, N = B.shape
    if A.shape != (K, r):
        raise ValueError(f"lowrank_matmul: x {tuple(x.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}")
    ldx = row_stride(x, "lowrank_matmul x")
    lda = row_stride(A, "lowrank_matmul A")
    ldb = row_stride(B, "lowrank_matmul B")
    t = padded_rows(M, r, x.dtype, x.device)  # scratch for the rounded x @ A
    y = padded_rows(M, N, x.dtype, x.device)
    # fp32 split-K partials of the decode-sized (M <= 8) path; 0 bytes otherwise
    ws_bytes = KERNEL.query("lowrank_matmul_workspace_bytes", M, K, r, N, x.element_size())
    ws = torch.empty((max(ws_bytes, 4) // 4,), dtype=torch.float32, device=x.device)
    entry = "lowrank_matmul_f32" if x.dtype == torch.float32 else "lowrank_matmul_bf16"
    KERNEL.launch(entry, x.device, x.data_ptr(), A.data_ptr(), B.data_ptr(), t.data_ptr(), ws.data_ptr(),
                  y.data_ptr(), M, K, r, N, ldx, lda, t.stride(0), ldb, y.stride(0))
    return y
