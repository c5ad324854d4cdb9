"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

One-token GQA attention over a flat cache with a strict per-slot valid
mask; fully-masked rows give zeros.  Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas``.

What bounds it on the H100 is latency, not bytes: a call reads a few MB
at most, so its time is the launch and the chain of dependent reads.  One
launch does the whole call (no workspace, no second pass): the cache's
positions are cut into 16-position warp tiles, dealt round-robin over a
cluster of blocks, each warp running the online softmax on its tiles (bf16
on tensor cores) and skipping tiles the mask leaves empty; the cluster
combines its partials through distributed shared memory
(``csrc/decode_attention.cuh``).  :func:`decode_plan` picks the cluster
from the shapes and the card's SM count alone, so the launch is safe to
capture in a CUDA graph; the paged kernel shares it.

On a CPU tensor the plain version (``ref.decode_attention_ref``) runs; on a
CUDA tensor the kernel launches or this raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, KernelLib, P, check_vector_layout, sm_count

__all__ = ["KERNEL", "DecodePlan", "decode_attention", "decode_plan", "plan_groups", "sm_count", "smem_bytes"]

# csrc/decode_attention.cuh's constants
TILE = 16  # positions a warp tile
MAX_CLUSTER = 8  # blocks a cluster (the portable limit)
MAX_WARPS = 4  # warps a block
HEADS = 8  # query heads a block (G in chunks of 8)
VMAX = 256  # V features a block (vd in chunks of 256)
WARP_EXTRA = 640  # bytes a warp: 16 row indices and a P buffer
SMEM_MAX = 232448  # dynamic shared memory a block may take on the H100
SM_SMEM = 233472  # shared memory of one SM, 1 KB of it reserved a resident block

_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, I, P]
KERNEL = KernelLib("decode_attention", {
    "decode_attention_bf16": _ARGS,
    "decode_attention_f32": _ARGS,
})


class DecodePlan(NamedTuple):
    clusters: int  # blocks a (batch row, KV head) cluster
    warps: int  # warps a block
    stages: int  # ring stages a warp


def _stride(n: int, esz: int) -> int:
    return -(-n // 16) * 16 + 8 if esz == 2 else n + 4


def smem_bytes(warps: int, stages: int, hd: int, vd: int, esz: int) -> int:
    """Dynamic shared memory of one block (``decode_attention.cuh::smem_bytes``)."""
    vw = min(vd, VMAX)
    ring = warps * stages * TILE * esz * (_stride(hd, esz) + _stride(vw, esz))
    parts = (warps + 1) * HEADS * (vw + 2) * 4
    return max(ring, parts) + HEADS * _stride(hd, esz) * esz + warps * WARP_EXTRA


def blocks_per_sm(warps: int, stages: int, hd: int, vd: int, esz: int) -> int:
    """Blocks of this shape one SM holds at once, by shared memory and threads."""
    return min(SM_SMEM // (smem_bytes(warps, stages, hd, vd, esz) + 1024), 64 // warps, 32)


@functools.lru_cache(maxsize=None)
def decode_plan(S: int, hd: int, vd: int, esz: int, groups: int, sms: int) -> DecodePlan:
    """The launch plan over S positions for ``groups`` clusters a call (batch
    rows x KV heads x head chunks x feature chunks) on a card of ``sms``
    SMs: the fewest 16-position tiles a warp (at most 8 blocks of 4 warps a
    cluster) such that every block of the call is resident at once, then the
    fewest blocks, then the warps balanced over them; a ring of min(2, tiles
    a warp) stages.  Fewer warps a block where a two-stage ring would not
    fit in shared memory (wide fp32 heads), one stage where none would."""
    n_tiles = -(-S // TILE)
    warps, max_stages = next(((w, st) for st in (2, 1) for w in (MAX_WARPS, 2, 1)
                              if smem_bytes(w, st, hd, vd, esz) <= SMEM_MAX), (0, 0))
    if not warps:
        raise ValueError(f"decode attention: head dims ({hd}, {vd}) at {esz} bytes an element do not fit one "
                         f"block's shared memory")
    per_warp = -(-n_tiles // (MAX_CLUSTER * warps))
    while True:
        stages = min(max_stages, per_warp)
        clusters = -(-n_tiles // (warps * per_warp))
        if clusters == 1 or clusters * groups <= sms * blocks_per_sm(warps, stages, hd, vd, esz):
            return DecodePlan(clusters, -(-n_tiles // (clusters * per_warp)), stages)
        per_warp += 1


def plan_groups(B: int, KV: int, G: int, vd: int) -> int:
    """The clusters one call launches: batch rows x KV heads x head chunks x feature chunks."""
    return B * KV * -(-G // HEADS) * -(-vd // VMAX)


def decode_attention(q, k_cache, v_cache, valid, *, return_lse: bool = False):
    """q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool -> (B, 1, H, vd) in q's dtype; with ``return_lse``
    also each head's fp32 log-sum-exp (B, H) of its scores over the valid
    positions (-inf where none is), which combines attentions over a cache
    split across ranks.  Without it the kernel writes no lse."""
    ts = (q, k_cache, v_cache, valid)
    if all(t.device.type == "cpu" for t in ts):
        return ref.decode_attention_ref(q, k_cache, v_cache, valid, return_lse=return_lse)
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
    plan = decode_plan(S, hd, vd, q.element_size(), plan_groups(B, KV, H // KV, vd), sm_count(q.device.index or 0))
    out = torch.empty((B, 1, H, vd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    entry = "decode_attention_f32" if q.dtype == torch.float32 else "decode_attention_bf16"
    KERNEL.launch(entry, q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, S, KV, H // KV, hd, vd, hd**-0.5, *plan)
    return (out, lse) if return_lse else out
