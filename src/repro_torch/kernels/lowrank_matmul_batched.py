"""Wrapper of the batched low-rank linear kernel (``csrc/lowrank_matmul_batched.cu``).

``y[l] = (x[l] @ A[l]) @ B[l]`` over a stack of L factor pairs, one call for
the whole stack: the path of every RSI-compressed MoE expert stack.  Each
``(x[l] @ A[l])`` accumulates in fp32 and is rounded to x's dtype before
``@ B[l]``.  Replaces the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul_batched_pallas``.  Every
rank is accepted: there is no residency budget to fit.

Operands are read in place through their row and stack strides (a layer's
``(E, K, r)`` slice of a row-padded ``(L, E, K, r)`` factor leaf is such a
view); nothing is copied to make it contiguous.  The bf16 kernel reads them
by TMA, which needs bases, row strides and stack strides on 16 bytes: any
other operand is copied into aligned rows first and counted in
``_build.ALIGN_COPIES``.

The finite-factor contract (bf16): a first pass flags which 64-row granules
of each x[l] hold a nonzero element, and a tile of rows with none is not
computed: its rows of y are written as zeros.  For finite factors that is
exactly the product (a zero row of x gives a zero row of t and of y), and
the bits of a live row do not depend on which tiles are live.  Factors
holding inf or NaN would give NaN in those rows; the MoE caller's dead
capacity rows are exact zeros.  The launch plan (``lowrank_matmul.batched_plans``)
is a function of the shapes and the SM count only, and nothing is read back
to the host.

On a CPU tensor the plain version (``ref.lowrank_matmul_ref``, which
broadcasts over the stack) runs; on a CUDA tensor the kernel launches or
this raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import LL, I, KernelLib, P, padded_stack, sm_count, stack_strides, tma_ready
from repro_torch.kernels.lowrank_matmul import batched_plans

__all__ = ["KERNEL", "lowrank_matmul_batched", "live_flag_bytes"]

_ARGS_F32 = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, LL, LL, LL, LL, LL, P]
_ARGS_BF16 = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, LL, LL, LL, LL, LL, I, I, I, I, I, I, P]
KERNEL = KernelLib("lowrank_matmul_batched", {
    "lowrank_matmul_batched_bf16": _ARGS_BF16,
    "lowrank_matmul_batched_f32": _ARGS_F32,
})

_MAX_STACK = 65535  # the grid's z extent
GRANULE, LIVE_COLS = 64, 512  # csrc/lowrank_matmul_batched.cu: rows a flag, columns a flag


def live_flag_bytes(L: int, M: int, K: int) -> int:
    """Scratch of the liveness pass: one byte per (stack entry, 64-row granule, 512-column part)."""
    return L * -(-M // GRANULE) * -(-K // LIVE_COLS)


def lowrank_matmul_batched(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """x: (L, M, K); A: (L, K, r); B: (L, r, N) -> (L, M, N) in x's dtype.

    bf16 on the card: rows of x in a 64-row granule that is all zero come out
    as zero rows of y without being computed (exact for finite factors; see
    the module docstring)."""
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
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x = tma_ready(x, "lowrank_matmul_batched x")
        A, B = tma_ready(A, "lowrank_matmul_batched A"), tma_ready(B, "lowrank_matmul_batched B")
    ldx, sx = stack_strides(x, "lowrank_matmul_batched x")
    lda, sa = stack_strides(A, "lowrank_matmul_batched A")
    ldb, sb = stack_strides(B, "lowrank_matmul_batched B")
    t = padded_stack(L, M, r, x.dtype, x.device)  # scratch for the rounded x[l] @ A[l]
    y = padded_stack(L, M, N, x.dtype, x.device)
    strides = (ldx, lda, t.stride(1), ldb, y.stride(1), sx, sa, t.stride(0), sb, y.stride(0))
    if not bf16:
        KERNEL.launch("lowrank_matmul_batched_f32", x.device, x.data_ptr(), A.data_ptr(), B.data_ptr(),
                      t.data_ptr(), y.data_ptr(), L, M, K, r, N, *strides)
        return y
    p1, p2 = batched_plans(L, M, K, r, N, sm_count(x.device.index or 0))
    flags = torch.empty((max(1, live_flag_bytes(L, M, K)),), dtype=torch.uint8, device=x.device)
    KERNEL.launch("lowrank_matmul_batched_bf16", x.device, x.data_ptr(), A.data_ptr(), B.data_ptr(),
                  t.data_ptr(), y.data_ptr(), flags.data_ptr(), L, M, K, r, N, *strides, *p1, *p2)
    return y
