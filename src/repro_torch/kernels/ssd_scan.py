"""Wrapper of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``), and its launch plan.

``ssd_scan(x, dt, B_in, C_in, A)`` -> (y, final_state): x (B, L, nh, hd)
raw, dt (B, L, nh) fp32 after softplus, B_in/C_in (B, L, s) in x's dtype,
A (nh,) fp32 and negative; y in x's dtype, the state (B, nh, hd, s) fp32.
Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` and,
in the model, the reference's ``models/ssm.py::_ssd_chunk_scan``.  One
launch a call.

``round_xbar`` picks the contract for x̄ = x * dt: rounded to x's dtype
before the scan (the model's, ``repro/models/ssm.py:148``) or kept in fp32
(the TPU kernel's); the two agree in fp32.  The kernel walks chunks of its
own fixed length, 64 (one 64-row tile; ``chunk``, default 128 as
``ssd_scan_pallas``'s, feeds the reference's chunk rule, which only the
plain version follows: the two differ in summation order only).

bf16 runs the chunk's four products on tensor cores (mma.sync), and an
operand that carries fp32 values (the decayed scores, the state, the
weighted B) enters as a bf16 hi part and a bf16 lo part, so none loses
fp32 accuracy (``csrc/ssd_scan.cu`` says how).  fp32 keeps FMA products.
The launch plan (:func:`ssd_plan`) is a function of the shapes and the
card's SM count alone: the columns of one head a block owns, the threads,
the padded state width, the shared memory, the grid and the cluster (the
column tiles of one head, which share its decayed scores).

On a CPU tensor the plain version (``ref.ssd_scan_plain``) runs; on a CUDA
tensor the kernel launches or this raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, KernelLib, P, sm_count

__all__ = ["KERNEL", "MAX_STATE", "CHUNK", "COLS", "SMEM_MAX", "SsdPlan", "ssd_plan", "cluster_size", "mma_smem",
           "fma_smem", "ssd_scan"]

MAX_STATE = 256  # largest state dim the kernels' shared-memory layouts take
CHUNK = 64  # the kernels' own chunk (csrc/ssd_scan.cu::Q)
SMEM_MAX = 232448  # dynamic shared memory a block may take on the H100
COLS = (32, 16)  # columns a block, widest first (bf16: 32 only for s <= 128)
THREADS = 256  # both kernels: bf16 four warp pairs (intra-chunk rows, state tiles), fp32 eight warps
SCORE_BYTES = 10 * 2 * 32 * 16  # the bf16 kernel's decayed-score fragments: 10 tiles, hi and lo, 16 B a lane
MAX_CLUSTER = 4  # blocks a cluster: 16 intra warps for the bf16 kernel's 10 score tiles
_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
KERNEL = KernelLib("ssd_scan", {"ssd_scan_bf16": _ARGS, "ssd_scan_f32": _ARGS})


class SsdPlan(NamedTuple):
    cols: int  # head-dim columns a block (divides hd)
    threads: int
    s_pad: int  # the state width the kernel computes: s rounded up to 16 (bf16), zeros past s; s (fp32)
    smem: int  # dynamic shared memory bytes a block
    grid: Tuple[int, int, int]  # (hd / cols, nh, B)
    cluster: int  # bf16: blocks a cluster, column tiles of one head sharing its decayed scores; fp32: 1


def cluster_size(col_tiles: int) -> int:
    """The largest divisor of a head's column tiles that is at most 4."""
    return next(c for c in range(MAX_CLUSTER, 0, -1) if col_tiles % c == 0)


def mma_smem(cols: int, s_pad: int) -> int:
    """Dynamic shared memory of a bf16 block (``ssd_scan.cu::mma_smem``): 1 KB
    to align it; two ring stages of B and C (64-column TMA boxes of 64 rows),
    x and dt; the state's hi/lo copy, double-buffered; each of the 8 warps'
    l and decay factors; the decayed scores' A fragments (10 tiles of
    16 x 16, hi and lo), double-buffered; two mbarriers."""
    stage = 2 * -(-s_pad // 64) * CHUNK * 64 * 2 + CHUNK * cols * 2 + 1024
    return 1024 + 2 * stage + 4 * 2 * s_pad * (cols + 8) + (THREADS // 32) * 2 * CHUNK * 4 + 2 * SCORE_BYTES + 2 * 8


def fma_smem(cols: int, s: int) -> int:
    """Dynamic shared memory of an fp32 block (``ssd_scan.cu::fma_smem``)."""
    return 4 * (2 * CHUNK * (s + 1) + CHUNK * (cols + 1) + CHUNK * (CHUNK + 1) + cols * (s + 1) + 4 * CHUNK)


def ssd_plan(B: int, L: int, nh: int, hd: int, s: int, dtype: torch.dtype, n_sms: int) -> SsdPlan:
    """The launch of one ``ssd_scan`` call.  Blocks own ``cols`` columns of
    one head of one sequence (columns are independent), so the grid is
    (hd / cols, nh, B).  ``L`` does not enter: every chunk runs in the block.

    bf16: a block's chunk time follows its columns' work (the state term, the
    intra-chunk product and the state update grow with ``cols``; the decayed
    scores, shared over the cluster, do not), and a second block on an SM
    costs about as much again.  So ``cols`` is the narrowest tile whose grid
    still fits one block an SM, else the widest.  fp32 (FMA loops): the
    widest tile that still gives every SM a block, else the narrowest."""
    bf16 = dtype == torch.bfloat16
    s_pad, smem = (-(-s // 16) * 16, mma_smem) if bf16 else (s, fma_smem)
    cands = [c for c in COLS if hd % c == 0 and not (bf16 and c == 32 and s_pad > 128) and smem(c, s_pad) <= SMEM_MAX]
    if not cands:
        raise ValueError(f"ssd_plan: no column tile divides hd {hd} within shared memory at state {s}")
    if bf16:
        cols = next((c for c in reversed(cands) if B * nh * (hd // c) <= n_sms), cands[0])
    else:
        cols = next((c for c in cands if B * nh * (hd // c) >= n_sms), cands[-1])
    cluster = cluster_size(hd // cols) if bf16 else 1
    return SsdPlan(cols, THREADS, s_pad, smem(cols, s_pad), (hd // cols, nh, B), cluster)


def ssd_scan(x, dt, B_in, C_in, A, *, chunk: int = 128, round_xbar: bool = False):
    """Returns (y (B, L, nh, hd) in x's dtype, final_state (B, nh, hd, s) fp32)."""
    ts = (x, dt, B_in, C_in, A)
    if all(t.device.type == "cpu" for t in ts):
        return ref.ssd_scan_plain(x, dt, B_in, C_in, A, chunk=chunk, round_xbar=round_xbar)
    if any(t.device != x.device for t in ts) or x.device.type != "cuda":
        raise ValueError(f"ssd_scan: operands on {[str(t.device) for t in ts]}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not (x.dtype == B_in.dtype == C_in.dtype):
        raise TypeError(f"ssd_scan: x, B_in, C_in dtypes {x.dtype}, {B_in.dtype}, {C_in.dtype}; "
                        "need one of bf16/fp32 for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be fp32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, L, nh, hd), got {tuple(x.shape)}")
    Bsz, L, nh, hd = x.shape
    s = B_in.shape[-1]
    if dt.shape != (Bsz, L, nh) or B_in.shape != (Bsz, L, s) or C_in.shape != (Bsz, L, s) or A.shape != (nh,):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B_in {tuple(B_in.shape)}, "
                         f"C_in {tuple(C_in.shape)}, A {tuple(A.shape)}")
    if L < 1 or hd % 16 or not 1 <= s <= MAX_STATE:
        raise ValueError(f"ssd_scan: L {L} >= 1, hd {hd} a multiple of 16 and state {s} in [1, {MAX_STATE}] needed")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan: operands must be contiguous")
    y = torch.empty_like(x)
    state = torch.empty((Bsz, nh, hd, s), dtype=torch.float32, device=x.device)
    plan = ssd_plan(Bsz, L, nh, hd, s, x.dtype, sm_count(x.device.index or 0))
    entry = "ssd_scan_f32" if x.dtype == torch.float32 else "ssd_scan_bf16"
    KERNEL.launch(entry, x.device, x.data_ptr(), dt.data_ptr(), B_in.data_ptr(), C_in.data_ptr(), A.data_ptr(),
                  y.data_ptr(), state.data_ptr(), Bsz, L, nh, hd, s, int(round_xbar), plan.cols, plan.cluster)
    return y, state
