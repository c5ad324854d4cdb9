"""Wrapper of the batched low-rank linear kernel (``csrc/lowrank_matmul_batched.cu``).

``y[l] = (x[l] @ A[l]) @ B[l]`` over a stack of L factor pairs, one call for
the whole stack: the path of every RSI-compressed MoE expert stack.  Each
``(x[l] @ A[l])`` accumulates in fp32 and is rounded to x's dtype before
``@ B[l]``.  Replaces the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul_batched_pallas``.  Every
rank is accepted: there is no residency budget to fit.

Operands are read in place through their row and stack strides (a layer's
``(E, K, r)`` slice of a row-padded ``(L, E, K, r)`` factor leaf is such a
view); nothing is copied to make it contiguous.

On a CPU tensor the plain version (``ref.lowrank_matmul_ref``, which
broadcasts over the stack) runs; on a CUDA tensor the kernel launches or
this raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import LL, I, KernelLib, P, padded_stack, stack_strides

__all__ = ["KERNEL", "lowrank_matmul_batched"]

_ARGS = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, LL, LL, LL, LL, LL, P]
KERNEL = KernelLib("lowrank_matmul_batched", {
    "lowrank_matmul_batched_bf16": _ARGS,
    "lowrank_matmul_batched_f32": _ARGS,
})

_MAX_STACK = 65535  # the grid's z extent


def lowrank_matmul_batched(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x: (L, M, K); A: (L, K, r); B: (L, r, N) -> (L, M, N) in x's dtype."""
    devs = {x.device.type, A.device.type, B.device.type}
    if devs == {"cpu"}:
        return ref.lowrank_matmul_ref(x, A, B)
    if devs != {"cuda"} or not (x.device == A.device == B.device):
        raise ValueError(f"lowrank_matmul_batched: operands on {x.device}, {A.device}, {B.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not (x.dtype == A.dtype == B.dtype):
        raise TypeError(f"lowrank_matmul_batched: dtypes {x.dtype}, {A.dtype}, {B.dtype}; need one of bf16/fp32")
    if x.dim() != 3 or A.dim() != 3 or B.dim() != 3:
        raise ValueError(f"lowrank_matmul_batched: 3-D operands, got x {tuple(x.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    L, M, K = x.shape
    r, N = B.shape[1:]
    if A.shape != (L, K, r) or B.shape[0] != L:
        raise ValueError(f"lowrank_matmul_batched: x {tuple(x.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}")
    if L > _MAX_STACK:
        raise ValueError(f"lowrank_matmul_batched: stack of {L} > {_MAX_STACK}")
    ldx, sx = stack_strides(x, "lowrank_matmul_batched x")
    lda, sa = stack_strides(A, "lowrank_matmul_batched A")
    ldb, sb = stack_strides(B, "lowrank_matmul_batched B")
    t = padded_stack(L, M, r, x.dtype, x.device)  # scratch for the rounded x[l] @ A[l]
    y = padded_stack(L, M, N, x.dtype, x.device)
    entry = "lowrank_matmul_batched_f32" if x.dtype == torch.float32 else "lowrank_matmul_batched_bf16"
    KERNEL.launch(entry, x.device, x.data_ptr(), A.data_ptr(), B.data_ptr(), t.data_ptr(), y.data_ptr(),
                  L, M, K, r, N, ldx, lda, t.stride(1), ldb, y.stride(1), sx, sa, t.stride(0), sb, y.stride(0))
    return y
