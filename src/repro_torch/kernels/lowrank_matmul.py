"""Wrapper of the low-rank linear kernel (``csrc/lowrank_matmul.cu``), and
the launch plans of both low-rank kernels.

``y = (x @ A) @ B``: the ``(x @ A)`` intermediate accumulates in fp32 and is
rounded to x's dtype before ``@ B``.  Replaces the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas``.  Every rank is
accepted: there is no residency budget to fit, unlike the TPU kernel's VMEM
check.

Each stage is one launch under a plan computed here from the shapes and the
card's SM count alone (never from the data), so a captured CUDA graph
replays the same grid:

* M <= 8 (decode): the skinny kernel (bf16 on mma.sync, fp32 on the FMA
  units).  A block owns ``bn`` columns of the factor and one of ``splits``
  runs of its 64-row k-blocks; the runs of a column tile form a
  thread-block cluster that sums its partials in rank order, so a stage is
  one launch with no workspace.  The plan keeps every block of the launch
  resident in one wave where any plan can.
* M > 8 (prefill), and every batched call, bf16: the wgmma + TMA GEMM
  (``csrc/gemm_wgmma.cuh``) on a ``bm`` x ``bn`` tile with K split over a
  cluster of ``splits`` blocks; fp32: ``gemm_tile.cuh``'s 64 x 64 FMA tiles
  (:data:`FMA_TILES`).

The plan of a stage picks the candidate with the least modelled time: the
bytes of the factor (skinny) or of both tiles (wgmma) that a block pulls per
k-block, times its k-blocks plus a fixed cost, against the card's SMs.

TMA reads the factors (and, bf16 at M > 8, x) in place when their bases
and row strides lie on 16 bytes; any other operand is copied into aligned rows
first and counted in ``_build.ALIGN_COPIES``.

On a CPU tensor the plain version (``ref.lowrank_matmul_ref``) runs; on a
CUDA tensor the kernel launches or this raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import I, KernelLib, P, padded_rows, row_stride, sm_count, tma_ready

__all__ = [
    "KERNEL",
    "GemmPlan",
    "lowrank_matmul",
    "lowrank_plans",
    "batched_plans",
    "skinny_plan",
    "tile_plan",
    "skinny_smem",
    "skinny_per_sm",
    "tile_smem",
    "tile_per_sm",
    "split_range",
    "FMA_TILES",
]

# csrc/lowrank_matmul.cu's and csrc/gemm_wgmma.cuh's constants
BK = 64  # rows of K a k-block (a ring stage)
SKINNY_MAX_M = 8  # rows the skinny kernel takes
SKINNY_BNS = (128, 64, 32)  # its column tiles
SKINNY_RING = 65536  # bytes of the factor in flight a skinny block (at most)
SKINNY_THREADS = 160  # four consumer warps and a producer warp
TILES = ((128, 64), (256, 160), (128, 256))  # the wgmma tiles (bm, bn)
TILE_STAGES = 4
MAX_SPLITS = 8  # blocks a (portable) cluster
SMEM_MAX = 232448  # dynamic shared memory a block may take on the H100
SM_SMEM = 233472  # shared memory of one SM, 1 KB of it reserved a resident block
MAX_GRID_YZ = 65535
# a block's fixed cost in k-blocks of its own work: the skinny kernel's x chunk and combine,
# the wgmma tile's ring fill and epilogue
SKINNY_OVERHEAD, TILE_OVERHEAD = 2, 8

_ARGS = [P, P, P, P, P] + [I] * 9 + [I] * 6 + [P]
KERNEL = KernelLib("lowrank_matmul", {
    "lowrank_matmul_bf16": _ARGS,
    "lowrank_matmul_f32": _ARGS,
})


class GemmPlan(NamedTuple):
    bm: int  # rows a block: 0 for the skinny (M <= 8) kernel, else the wgmma (or FMA) tile's
    bn: int  # columns a block
    splits: int  # blocks a cluster, each one run of K's 64-row k-blocks, summed in rank order


FMA_TILES = GemmPlan(64, 64, 1)  # fp32 at M > 8: gemm_tile.cuh's 64 x 64 FMA tiles, no split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_range(nkb: int, splits: int, rank: int) -> Tuple[int, int]:
    """The k-blocks [lo, hi) that cluster rank ``rank`` sums (both kernels)."""
    return rank * nkb // splits, (rank + 1) * nkb // splits


def skinny_stages(bn: int, nk: int, esz: int = 2) -> int:
    return min(nk, SKINNY_RING // (BK * bn * esz))


def skinny_smem(bn: int, nk: int, esz: int = 2) -> int:
    """Dynamic shared memory of a skinny block whose K run is at most ``nk``
    k-blocks of ``esz``-byte elements (``lowrank_matmul.cu::sk_smem``): the
    ring, x's chunk, the block's partial, and 1 KB to align the ring."""
    return (1024 + skinny_stages(bn, nk, esz) * BK * bn * esz + SKINNY_MAX_M * (nk * BK + 8) * esz
            + SKINNY_MAX_M * bn * 4)


def skinny_per_sm(bn: int, nk: int, esz: int = 2) -> int:
    """Skinny blocks one SM holds at once, by shared memory and threads."""
    return min(SM_SMEM // (skinny_smem(bn, nk, esz) + 1024), 2048 // SKINNY_THREADS, 32)


def tile_smem(bm: int, bn: int) -> int:
    """Dynamic shared memory of a wgmma block (``gemm_wgmma.cuh::Cfg::SMEM``)."""
    return TILE_STAGES * (bm + bn) * BK * 2 + 1024


def tile_per_sm(bm: int, bn: int) -> int:
    return 2 if 2 * (tile_smem(bm, bn) + 1024) <= SM_SMEM else 1


@functools.lru_cache(maxsize=None)
def skinny_plan(K: int, N: int, sms: int, esz: int = 2) -> GemmPlan:
    """The skinny kernel's plan for a (<= 8, K) @ (K, N) stage of ``esz``-byte
    elements on ``sms`` SMs: the column tile and split with the least
    modelled time, among those whose blocks are all resident in one wave
    where any are."""
    nkb = max(1, _cdiv(K, BK))
    best, best_one_wave = None, None
    for bn in SKINNY_BNS:
        tiles = _cdiv(N, bn)
        if tiles > MAX_GRID_YZ:
            continue
        for s in range(1, min(MAX_SPLITS, nkb) + 1):
            nk = _cdiv(nkb, s)
            if skinny_smem(bn, nk, esz) > SMEM_MAX:
                continue
            blocks = tiles * s
            work = (nk + SKINNY_OVERHEAD) * bn
            key = (max(blocks * work / sms, work), s, -bn)
            if best is None or key < best[0]:
                best = (key, GemmPlan(0, bn, s))
            if blocks <= sms * skinny_per_sm(bn, nk, esz) and (best_one_wave is None or key < best_one_wave[0]):
                best_one_wave = (key, GemmPlan(0, bn, s))
    if best is None:
        raise ValueError(f"lowrank_matmul: no skinny plan fits K={K}, N={N}")
    return (best_one_wave or best)[1]


@functools.lru_cache(maxsize=None)
def tile_plan(M: int, K: int, N: int, sms: int, L: int = 1) -> GemmPlan:
    """The wgmma GEMM's plan for L stacked (M, K) @ (K, N) products on ``sms``
    SMs: the tile and split with the least modelled time.  A stack (the
    expert capacity, L > 1) takes a tile at least as tall as M where one
    exists, so each expert's factor tiles are read by one block (cluster)."""
    nkb = max(1, _cdiv(K, BK))
    rows = _cdiv(M, 64) * 64  # rows past M are zero-filled by TMA: no bytes
    best = None
    for bm, bn in TILES:
        if L > 1 and M <= max(b for b, _ in TILES) and bm < M:
            continue
        mt, nt = _cdiv(M, bm), _cdiv(N, bn)
        if mt > MAX_GRID_YZ:
            continue
        for s in range(1, min(MAX_SPLITS, nkb) + 1):
            if L * s > MAX_GRID_YZ:
                break
            blocks = L * mt * nt * s
            work = (_cdiv(nkb, s) + TILE_OVERHEAD) * (min(bm, rows) + bn)
            key = (max(blocks * work / sms, work), s, -bm * bn)
            if best is None or key < best[0]:
                best = (key, GemmPlan(bm, bn, s))
    if best is None:
        raise ValueError(f"lowrank_matmul: no tile plan fits L={L}, M={M}, K={K}, N={N}")
    return best[1]


def lowrank_plans(M: int, K: int, r: int, N: int, sms: int, esz: int = 2) -> Tuple[GemmPlan, GemmPlan]:
    """The two stages' plans of a 2-D call on ``esz``-byte elements (2 bf16,
    4 fp32): x (M, K) @ A (K, r), then t @ B (r, N)."""
    if M <= SKINNY_MAX_M:
        return skinny_plan(K, r, sms, esz), skinny_plan(r, N, sms, esz)
    if esz == 4:
        return FMA_TILES, FMA_TILES
    return tile_plan(M, K, r, sms), tile_plan(M, r, N, sms)


def batched_plans(L: int, M: int, K: int, r: int, N: int, sms: int) -> Tuple[GemmPlan, GemmPlan]:
    """The two stages' plans of a batched bf16 call over L stacked factor pairs."""
    return tile_plan(M, K, r, sms, L), tile_plan(M, r, N, sms, L)


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
    t = padded_rows(M, r, x.dtype, x.device)  # scratch for the rounded x @ A
    y = padded_rows(M, N, x.dtype, x.device)
    skinny = M <= SKINNY_MAX_M
    if skinny or x.dtype == torch.bfloat16:  # TMA reads the factors (the FMA tiles need not)
        A, B = tma_ready(A, "lowrank_matmul A"), tma_ready(B, "lowrank_matmul B")
    if not skinny and x.dtype == torch.bfloat16:  # the wgmma tiles load x by TMA too
        x = tma_ready(x, "lowrank_matmul x")
    p1, p2 = lowrank_plans(M, K, r, N, sm_count(x.device.index or 0), x.element_size())
    entry = "lowrank_matmul_f32" if x.dtype == torch.float32 else "lowrank_matmul_bf16"
    KERNEL.launch(entry, x.device, x.data_ptr(), A.data_ptr(), B.data_ptr(), t.data_ptr(), y.data_ptr(),
                  M, K, r, N, row_stride(x, "lowrank_matmul x"), row_stride(A, "lowrank_matmul A"), t.stride(0),
                  row_stride(B, "lowrank_matmul B"), y.stride(0), *p1, *p2)
    return y
