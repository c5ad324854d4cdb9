"""Wrapper of the paged flash-decode kernel (``csrc/paged_decode_attention.cu``).

One-token GQA attention over a paged KV pool through a per-slot block
table, with the flat kernel's numerics; positions at or past a slot's
``n_valid`` are masked and a slot with ``n_valid`` 0 gives zeros.  Replaces
the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention_pallas``.

The kernel is the flat kernel's (``csrc/decode_attention.cuh``: one
launch, 16-position warp tiles over a cluster, bf16 on tensor cores, the
clusters' partials combined through distributed shared memory) with the
block table in place of the mask: each tile resolves its page ids before
its copies are issued, and tiles at or past ``n_valid`` are skipped.  The
plan is the flat kernel's at S = n_tbl * page (:func:`paged_plan`), so on
the same logical cache the two return the same bits.

On a CPU tensor the plain version (``ref.paged_decode_attention_ref``)
runs; on a CUDA tensor the kernel launches or this raises.  The launch is
safe to capture in a CUDA graph: no host sync, and the grid depends only on
the shapes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import F, I, KernelLib, P, check_vector_layout
from repro_torch.kernels.decode_attention import DecodePlan, decode_plan, plan_groups, sm_count

__all__ = ["KERNEL", "MAX_PAGE", "paged_decode_attention", "paged_plan"]

MAX_PAGE = 128  # the reference's VMEM_ANALYSIS_BOUNDS["page"]
_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, P]
KERNEL = KernelLib("paged_decode_attention", {
    "paged_decode_attention_bf16": _ARGS,
    "paged_decode_attention_f32": _ARGS,
})


def paged_plan(n_tbl: int, page: int, hd: int, vd: int, esz: int, groups: int, sms: int) -> DecodePlan:
    """The flat kernel's plan over the table's n_tbl * page logical positions."""
    return decode_plan(n_tbl * page, hd, vd, esz, groups, sms)


def paged_decode_attention(q, k_pool, v_pool, block_table, n_valid):
    """q: (B, 1, H, hd); k_pool: (P, page, KV, hd); v_pool: (P, page, KV, vd);
    block_table: (B, n_tbl) int32 page ids; n_valid: (B,) int32 valid logical
    positions per slot -> (B, 1, H, vd) in q's dtype."""
    ts = (q, k_pool, v_pool, block_table, n_valid)
    if all(t.device.type == "cpu" for t in ts):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_table, n_valid)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: operands on {[str(t.device) for t in ts]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"paged_decode_attention: dtypes {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or n_valid.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: block_table {block_table.dtype} and n_valid {n_valid.dtype} "
                        "must be int32")
    B, one, H, hd = q.shape
    P_, page, KV, _ = k_pool.shape
    vd = v_pool.shape[-1]
    n_tbl = block_table.shape[-1]
    if one != 1:
        raise ValueError(f"decode query must be one token, got q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if not 1 <= page <= MAX_PAGE:
        raise ValueError(f"paged_decode_attention: page size {page} not in [1, {MAX_PAGE}]")
    if k_pool.shape != (P_, page, KV, hd) or v_pool.shape[:3] != (P_, page, KV) \
            or block_table.shape != (B, n_tbl) or n_valid.shape != (B,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
                         f"v {tuple(v_pool.shape)}, block_table {tuple(block_table.shape)}, "
                         f"n_valid {tuple(n_valid.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention: operands must be contiguous")
    check_vector_layout("paged_decode_attention", q, k_pool, v_pool)
    plan = paged_plan(n_tbl, page, hd, vd, q.element_size(), plan_groups(B, KV, H // KV, vd),
                      sm_count(q.device.index or 0))
    out = torch.empty((B, 1, H, vd), dtype=q.dtype, device=q.device)
    entry = "paged_decode_attention_f32" if q.dtype == torch.float32 else "paged_decode_attention_bf16"
    KERNEL.launch(entry, q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
                  n_valid.data_ptr(), out.data_ptr(), B, n_tbl, page, KV, H // KV, hd, vd, hd**-0.5, *plan)
    return out
