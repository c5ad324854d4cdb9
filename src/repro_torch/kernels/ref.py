"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each mirrors its oracle in ``repro/kernels/ref.py`` or the reference model
code it stands in for, with the same contracts:

* products accumulate in fp32 (inputs are upcast before ``torch.matmul``,
  so a bf16 input never meets a bf16-accumulating GEMM);
* the ``(x @ A)`` intermediate of a low-rank apply is rounded to the input
  dtype before ``@ B``;
* fully-masked decode rows give zeros, never NaN;
* the SSD scan keeps its state and all its arithmetic in fp32.

The CPU tests and the wrappers' CPU path run these; ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "NEG_INF",
    "sketch_matmul_ref",
    "lowrank_matmul_ref",
    "decode_attention_ref",
    "gather_pages",
    "paged_decode_attention_ref",
    "flash_attention_ref",
    "chunked_attention_ref",
    "ssd_xbar",
    "ssd_scan_ref",
    "ssd_chunk_len",
    "ssd_chunk_scan_ref",
    "ssd_scan_plain",
]

NEG_INF = -1e30


def sketch_matmul_ref(a, b, *, trans_a: bool = False, out_dtype: Optional[torch.dtype] = None):
    """``op(a) @ b`` with fp32 accumulation, ``op(a) = a.T`` under ``trans_a``.

    a: (M, K), or (K, M) under ``trans_a``; b: (K, N).  The output is in
    ``out_dtype`` (default a's dtype) — fp32 output keeps the product unrounded.
    """
    a32 = a.float()
    if trans_a:
        a32 = a32.T
    return torch.matmul(a32, b.float()).to(out_dtype or a.dtype)


def lowrank_matmul_ref(x, A, B):
    """y = (x @ A) @ B — compressed-linear serving oracle.

    2-D factors, or stacked ones: x (L, M, K), A (L, K, r), B (L, r, N) give
    y[l] = (x[l] @ A[l]) @ B[l] (``torch.matmul`` batches over L), the plain
    version of both the 2-D and the batched kernel."""
    t = torch.matmul(x.float(), A.float()).to(x.dtype)
    return torch.matmul(t.float(), B.float()).to(x.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid):
    """Dense one-token GQA attention over a cache — flash-decode oracle.

    q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool strict per-slot mask.  q is scaled in fp32 and cast to
    the cache dtype; probabilities are re-masked after the exp, so a
    fully-masked row produces zeros.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qh = (q.reshape(B, KV, G, hd).float() * hd**-0.5).to(k_cache.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qh.float(), k_cache.float())
    live = valid[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bskv->bkgv", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def gather_pages(pool, block_table):
    """Reassemble a slot-contiguous cache view from a paged pool.

    pool: (P, page, ...) physical pages; block_table: (B, n_tbl) page ids
    (entries may point at the pool's trash page — callers mask by
    ``n_valid``).  Returns (B, n_tbl * page, ...): logical position ``t`` of
    slot ``b`` is ``pool[block_table[b, t // page], t % page]``.  A pure
    gather, so the view is bit-identical to a flat cache holding the same
    writes.
    """
    B, n_tbl = block_table.shape
    page = pool.shape[1]
    g = pool[block_table.long()]  # (B, n_tbl, page, ...)
    return g.reshape((B, n_tbl * page) + tuple(pool.shape[2:]))


def paged_decode_attention_ref(q, k_pool, v_pool, block_table, n_valid):
    """Gather-then-attend oracle of the paged flash-decode kernel.

    q: (B, 1, H, hd); pools: (P, page, KV, hd/vd); block_table: (B, n_tbl)
    int32; n_valid: (B,) int32 valid logical positions per slot.  Gathers
    the per-slot cache the kernel never materializes, then defers to
    :func:`decode_attention_ref`, so the paged and flat paths share one
    masking and zero-row contract.
    """
    k = gather_pages(k_pool, block_table)
    v = gather_pages(v_pool, block_table)
    S = k.shape[1]
    valid = torch.arange(S, device=q.device)[None, :] < n_valid.to(q.device)[:, None]
    return decode_attention_ref(q, k, v, valid)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain softmax attention oracle.  q/k/v: (B, S, H, hd) (same H); the
    scale is applied to the fp32 scores, after the dot."""
    B, S, H, hd = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd**-0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_mask(sq: int, skv: int, *, causal: bool, window: Optional[int], q_offset: int, device):
    """(Sq, Skv) bool mask of ``repro/models/attention.py::_mask_for``."""
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def chunked_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """Prefill attention with the numerics of ``_flash_fwd_pass`` in one chunk.

    q: (B, Sq, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, vd), GQA by head
    grouping (H = KV * G, K/V never repeated).  q is scaled in fp32 and cast
    back to q's dtype before the dot; p = exp(s - m) is cast to v's dtype
    before PV; the result is ``acc / max(l, 1e-30)``.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = (q.float() * hd**-0.5).to(q.dtype).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qs.float(), k.float())
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqc,bckv->bkgqv", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------- #
# Mamba2 SSD scan
# --------------------------------------------------------------------------- #
def ssd_xbar(x, dt, round_xbar: bool):
    """The scan's input x̄ = x * dt, in fp32.  Two contracts: the TPU kernel
    (``repro/kernels/ssd_scan.py:47``) keeps x̄ in fp32; the model
    (``repro/models/ssm.py:148``) rounds it to x's dtype first
    (``round_xbar``).  They agree in fp32 and differ in bf16."""
    xb = x.float() * dt.float()[..., None]
    return xb.to(x.dtype) if round_xbar else xb


def ssd_scan_ref(xbar, dt, B_in, C_in, A):
    """Sequential (non-chunked) SSD recurrence oracle
    (``repro/kernels/ref.py::ssd_scan_ref``).

    xbar: (B, L, nh, hd) dt-scaled inputs; dt: (B, L, nh); B_in/C_in:
    (B, L, s); A: (nh,) negative.  Returns (y (B, L, nh, hd) in xbar's
    dtype, final_state (B, nh, hd, s) fp32)."""
    Bsz, L, nh, hd = xbar.shape
    s = B_in.shape[-1]
    A32 = A.float()
    state = torch.zeros((Bsz, nh, hd, s), dtype=torch.float32, device=xbar.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t].float() * A32[None, :])  # (B, nh)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bs,bhd->bhds", B_in[:, t].float(), xbar[:, t].float())
        ys.append(torch.einsum("bs,bhds->bhd", C_in[:, t].float(), state))
    return torch.stack(ys, dim=1).to(xbar.dtype), state


def ssd_chunk_len(L: int, chunk: int) -> int:
    """The reference's chunk rule (``_ssd_chunk_scan``, ``ssd_scan_pallas``):
    Q = min(chunk, L), halved until it divides L (a prime L gives Q = 1)."""
    Q = min(chunk, L)
    while L % Q:
        Q //= 2
    return Q


def ssd_chunk_scan_ref(xbar, dt, B_in, C_in, A, chunk: int, *, state0=None, out_dtype=None):
    """Chunked SSD, the computation of ``repro/models/ssm.py::_ssd_chunk_scan``.

    xbar: (B, L, nh, hd) *already dt-scaled*; dt: (B, L, nh) fp32; B_in/C_in:
    (B, L, s); A: (nh,) negative.  Within a chunk of Q steps (``ssd_chunk_len``)
    the recurrence is a masked quadratic product; across chunks an fp32
    (B, nh, hd, s) state carries it.  The t < u half of the segment sums is
    positive and is masked BEFORE the exp, so it never overflows.  Returns
    (y (B, L, nh, hd) in ``out_dtype`` (default xbar's), final_state fp32)."""
    Bsz, L, nh, hd = xbar.shape
    s = B_in.shape[-1]
    Q = ssd_chunk_len(L, chunk)
    Nc = L // Q
    xc = xbar.reshape(Bsz, Nc, Q, nh, hd).float()
    Bc = B_in.reshape(Bsz, Nc, Q, s).float()
    Cc = C_in.reshape(Bsz, Nc, Q, s).float()
    lcum = torch.cumsum(dt.reshape(Bsz, Nc, Q, nh).float() * A.float(), dim=2)  # within-chunk log-decay
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xbar.device))[None, :, :, None]
    state = (torch.zeros((Bsz, nh, hd, s), dtype=torch.float32, device=xbar.device)
             if state0 is None else state0.float())
    ys = []
    for c in range(Nc):
        xq, bq, cq, lq = xc[:, c], Bc[:, c], Cc[:, c], lcum[:, c]
        cb = torch.einsum("bts,bus->btu", cq, bq)  # (B, Q, Q)
        seg = lq[:, :, None, :] - lq[:, None, :, :]  # (B, Q, Q, nh): l_t - l_u
        m = torch.exp(torch.where(tri, seg, torch.full_like(seg, NEG_INF)))
        y_intra = torch.einsum("btuh,buhd->bthd", cb[..., None] * m, xq)
        y_inter = torch.einsum("bts,bhds->bthd", cq, state) * torch.exp(lq)[..., None]
        l_last = lq[:, -1]  # (B, nh)
        w_in = torch.exp(l_last[:, None, :] - lq)  # (B, Q, nh): decay from step u to the chunk's end
        state = state * torch.exp(l_last)[:, :, None, None] + torch.einsum(
            "bus,buhd->bhds", bq, w_in[..., None] * xq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, L, nh, hd)
    return y.to(out_dtype or xbar.dtype), state


def ssd_scan_plain(x, dt, B_in, C_in, A, *, chunk: int, round_xbar: bool):
    """The plain version of the ``ssd_scan`` kernel: raw x (B, L, nh, hd) and
    dt (B, L, nh) fp32 after softplus; x̄ formed by :func:`ssd_xbar` under
    either contract, then the chunked scan with the reference's chunk rule.
    Returns (y in x's dtype, final_state (B, nh, hd, s) fp32)."""
    return ssd_chunk_scan_ref(ssd_xbar(x, dt, round_xbar), dt, B_in, C_in, A, chunk, out_dtype=x.dtype)
