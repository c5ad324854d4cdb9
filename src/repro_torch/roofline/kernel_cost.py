"""One cost formula per hand-written kernel: ``(flops, bytes_once)``.

``flops`` counts the operations the kernel's algorithm needs on these
shapes (a multiply-add is two), ``bytes_once`` each input read once and
each output written once.  They are the counts that ``chip_smoke.py``'s
phase 2 divides by the card's peak rates for each kernel's bound, and the
counts the dry-run records for each kernel call (``runtime/dispatch.py``
inside ``roofline/dry.py::dry_world``), so the card's bounds and the
roofline read the same formulas.  Where the work depends on the data (the
valid rows of a decode mask, the live experts of a stacked apply) the
caller passes what its inputs need.  Sizes are element sizes in bytes.
"""

from __future__ import annotations

import functools
from typing import Optional

__all__ = [
    "SSD_CHUNK",
    "attention_pairs",
    "lowrank_matmul",
    "lowrank_matmul_batched",
    "sketch_matmul",
    "flash_attention",
    "decode_attention",
    "paged_decode_attention",
    "ssd_ops",
    "ssd_scan",
]

SSD_CHUNK = 64  # the ssd_scan kernel's own chunk (csrc/ssd_scan.cu)


def lowrank_matmul(M: int, K: int, r: int, N: int, itemsize: int, out_itemsize: Optional[int] = None) -> tuple:
    """y (M, N) = (x (M, K) @ A (K, r)) @ B (r, N)."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    return 2 * M * K * r + 2 * M * r * N, itemsize * (M * K + K * r + r * N) + M * N * out_itemsize


def lowrank_matmul_batched(E: int, C: int, K: int, r: int, N: int, itemsize: int, *,
                           live_experts: Optional[int] = None, live_rows: Optional[int] = None) -> tuple:
    """E stacked applies of C rows each: the factors of the experts with a
    live row, x read once, y written whole.  Default: every row live."""
    n_live = E if live_experts is None else live_experts
    rows = E * C if live_rows is None else live_rows
    factor = (K * r + r * N) * itemsize  # one expert's factors
    return 2 * rows * (K * r + r * N), n_live * factor + E * C * K * itemsize + E * C * N * itemsize


def sketch_matmul(C: int, D: int, ell: int, itemsize: int, *, trans_a: bool = False,
                  out_itemsize: Optional[int] = None) -> tuple:
    """op(a) @ b with a (C, D) and b (D, ell), or (C, ell) under ``trans_a``;
    the logits are this GEMM with an fp32 output (``out_itemsize`` 4)."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    m_out = D if trans_a else C
    k_in = C if trans_a else D
    return 2 * C * D * ell, itemsize * (C * D + k_in * ell) + m_out * ell * out_itemsize


@functools.lru_cache(maxsize=4096)
def attention_pairs(sq: int, skv: int, causal: bool = True, window: Optional[int] = None, q_offset: int = 0) -> int:
    """(query, key) pairs a prefill attention scores: query row i sits at
    position q_offset + i and sees key j where j <= it (causal) and it - j
    < window."""
    total = 0
    for i in range(sq):
        p = q_offset + i
        hi = min(p + 1, skv) if causal else skv
        lo = max(0, p - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def flash_attention(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int, itemsize: int, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0, vd: Optional[int] = None) -> tuple:
    """q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, vd) -> (B, Sq, H, vd):
    QK^T and PV over the pairs the mask keeps."""
    vd = hd if vd is None else vd
    pairs = attention_pairs(Sq, Skv, causal, window, q_offset)
    by = itemsize * (B * Sq * H * hd + B * Skv * KV * (hd + vd) + B * Sq * H * vd)
    return 2 * B * H * pairs * (hd + vd), by


def decode_attention(B: int, S: int, H: int, KV: int, hd: int, itemsize: int, *, n_rows: int,
                     vd: Optional[int] = None) -> tuple:
    """One query a sequence over a (B, S) cache: q, the bool mask and the
    ``n_rows`` valid K/V rows read (a masked row need not be), out written."""
    vd = hd if vd is None else vd
    by = itemsize * B * H * hd + B * S + n_rows * KV * (hd + vd) * itemsize + B * H * vd * itemsize
    return 2 * H * (hd + vd) * n_rows, by


def paged_decode_attention(B: int, n_tbl: int, H: int, KV: int, hd: int, itemsize: int, *, n_rows: int) -> tuple:
    """As :func:`decode_attention` through a block table: q, the (B, n_tbl)
    int32 table and the (B,) int32 lengths read, then the valid rows."""
    by = itemsize * B * H * hd + 4 * B * n_tbl + 4 * B + n_rows * KV * 2 * hd * itemsize + B * H * hd * itemsize
    return 4 * H * hd * n_rows, by


def ssd_ops(B: int, L: int, nh: int, hd: int, s: int, Q: int = SSD_CHUNK) -> int:
    """Operations of the chunked SSD at chunk Q on these shapes, counting each
    product once: C B^T once per (sequence, chunk), shared by the heads; the
    masked intra-chunk product over its t >= u half; the carried state's
    contribution to y; the state update."""
    n_chunks = -(-L // Q)
    per_chunk = 2 * Q * Q * s + nh * (Q * (Q + 1) * hd + 2 * Q * s * hd + 2 * Q * s * hd)
    return B * n_chunks * per_chunk


def ssd_scan(B: int, L: int, nh: int, hd: int, s: int, itemsize: int) -> tuple:
    """x (B, L, nh, hd), fp32 dt (B, L, nh), B/C (B, L, s) and fp32 A (nh,)
    read; y (B, L, nh, hd) and the fp32 final state (B, nh, hd, s) written."""
    by = (2 * B * L * nh * hd * itemsize + 4 * B * L * nh + 2 * B * L * s * itemsize + 4 * nh
          + 4 * B * nh * hd * s)
    return ssd_ops(B, L, nh, hd, s), by
