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
    "flash_fwd_ref",
    "flash_bwd_ref",
    "lowrank_matmul_bwd_ref",
    "logits_bwd_ref",
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


def lowrank_matmul_ref(x, A, B, *, return_xa: bool = False):
    """y = (x @ A) @ B — compressed-linear serving oracle.

    2-D factors, or stacked ones: x (L, M, K), A (L, K, r), B (L, r, N) give
    y[l] = (x[l] @ A[l]) @ B[l] (``torch.matmul`` batches over L), the plain
    version of both the 2-D and the batched kernel.  ``return_xa``: also the
    rounded ``x @ A``."""
    t = torch.matmul(x.float(), A.float()).to(x.dtype)
    y = torch.matmul(t.float(), B.float()).to(x.dtype)
    return (y, t) if return_xa else y


def decode_attention_ref(q, k_cache, v_cache, valid, *, return_lse: bool = False):
    """Dense one-token GQA attention over a cache — flash-decode oracle.

    q: (B, 1, H, hd); k_cache: (B, S, KV, hd); v_cache: (B, S, KV, vd);
    valid: (B, S) bool strict per-slot mask.  q is scaled in fp32 and cast to
    the cache dtype; probabilities are re-masked after the exp, so a
    fully-masked row produces zeros.  ``return_lse``: also each head's fp32
    log-sum-exp (B, H) of its scores over the valid positions (-inf where
    none is).
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
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bkgs,bskv->bkgv", p.to(v_cache.dtype).float(), v_cache.float())
    out = out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    return out, lse.reshape(B, H)


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


Q_BLOCK = 1024  # query rows a block of the plain prefill attention


def chunked_attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                          return_lse: bool = False):
    """Prefill attention with the numerics of ``_flash_fwd_pass`` in one chunk.

    q: (B, Sq, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, vd), GQA by head
    grouping (H = KV * G, K/V never repeated).  q is scaled in fp32 and cast
    back to q's dtype before the dot; p = exp(s - m) is cast to v's dtype
    before PV; the result is ``acc / max(l, 1e-30)``.

    A prompt longer than ``Q_BLOCK`` runs in blocks of that many query
    rows, each against the keys its causal window can see (rows are
    independent, and a key no row of the block sees adds an exact zero), so
    the fp32 scores of a 16384-token prompt take a block's memory, not the
    whole (Sq, Skv) square's.

    ``return_lse``: also each row's fp32 log-sum-exp m + log(max(l, 1e-30)),
    (B, KV, G, Sq) as ``_flash_fwd_pass`` returns it (a key a block leaves
    out adds exp(-1e30 - m) = 0 to l, so the blocks' lse is the whole row's).
    """
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq <= Q_BLOCK:
        return _attention_block(q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=return_lse)
    outs = []
    for s0 in range(0, Sq, Q_BLOCK):
        s1 = min(Sq, s0 + Q_BLOCK)
        lo = 0 if window is None else max(0, q_offset + s0 - window + 1)
        hi = min(Skv, q_offset + s1) if causal else Skv
        outs.append(_attention_block(q[:, s0:s1], k[:, lo:hi], v[:, lo:hi], causal=causal, window=window,
                                     q_offset=q_offset + s0 - lo, return_lse=return_lse))
    if return_lse:
        return torch.cat([o for o, _ in outs], dim=1), torch.cat([lse for _, lse in outs], dim=-1)
    return torch.cat(outs, dim=1)


def flash_fwd_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """(out, lse): the plain forward of the flash kernel's training call, the
    twin of ``repro/models/attention.py::_flash_fwd_pass``."""
    return chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=True)


def _attention_block(q, k, v, *, causal: bool, window: Optional[int], q_offset: int, return_lse: bool = False):
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
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if return_lse:
        return out, m[..., 0] + torch.log(l_safe)
    return out


def _pick_chunk(s: int, target: int) -> int:
    """``repro/models/attention.py::_pick_chunk``: min(target, s), halved until it divides s."""
    c = min(target, s)
    while s % c:
        c //= 2
    return max(c, 1)


def flash_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, q_chunk: int = 2048, kv_chunk: int = 1024):
    """(dq, dk, dv) of the flash forward: the twin of ``repro/models/attention.py::_flash_bwd``.

    The probabilities are RECOMPUTED per (q, kv) chunk pair from the saved
    fp32 ``lse`` (B, KV, G, Sq), never stored as an (Sq, Skv) stack:
    p = exp(s - lse) from the scores of q scaled in fp32 and rounded to q's
    dtype; dv += round_v(p)^T dout; dp = dout v^T; ds = p (dp - delta) with
    delta = rowsum(dout * out) in fp32; dq += round_q(ds) k and
    dk += round_q(ds)^T q_scaled.  Products take their operands as fp32
    copies (fp32 accumulation, as the reference's
    ``preferred_element_type=f32``); dq, dk and dv accumulate in fp32 and
    are rounded once, dq after its ``* scale``.  The chunks follow the
    reference's rule (``_pick_chunk`` of ``q_chunk`` / ``kv_chunk``); a chunk
    pair the causal or window mask empties is skipped (its p is an exact 0).
    GQA: the G query heads of a KV head sum into its dk / dv.  vd may differ
    from hd (MLA's 192 / 128); the scale is hd**-0.5."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    scale = hd**-0.5
    cq, ckv = _pick_chunk(Sq, q_chunk), _pick_chunk(Skv, kv_chunk)
    qs = (q.float() * scale).to(q.dtype).float().reshape(B, Sq, KV, G, hd)
    do = dout.float().reshape(B, Sq, KV, G, vd)
    delta = (do * out.float().reshape(B, Sq, KV, G, vd)).sum(dim=-1).permute(0, 2, 3, 1)  # (B, KV, G, Sq)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Skv, KV, vd), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, cq):
        qsl = slice(q0, q0 + cq)
        q_lo, q_hi = q_offset + q0, q_offset + q0 + cq - 1  # the chunk's first and last query positions
        lse_c, delta_c = lse[..., qsl], delta[..., qsl]
        dq_acc = torch.zeros((B, cq, KV, G, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, ckv):
            if (causal and q_hi < k0) or (window is not None and q_lo - (k0 + ckv - 1) >= window):
                continue  # no (q, k) pair of the two chunks is live
            ksl = slice(k0, k0 + ckv)
            s = torch.einsum("bqkgh,bckh->bkgqc", qs[:, qsl], kf[:, ksl])
            mask = attention_mask(cq, ckv, causal=causal, window=window, q_offset=q_offset + q0 - k0,
                                  device=q.device)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lse_c[..., None])  # (B, KV, G, cq, ckv)
            dv[:, ksl] += torch.einsum("bkgqc,bqkgv->bckv", p.to(v.dtype).float(), do[:, qsl])
            dp = torch.einsum("bqkgv,bckv->bkgqc", do[:, qsl], vf[:, ksl])
            ds = (p * (dp - delta_c[..., None])).to(q.dtype).float()
            dq_acc += torch.einsum("bkgqc,bckh->bqkgh", ds, kf[:, ksl])
            dk[:, ksl] += torch.einsum("bkgqc,bqkgh->bckh", ds, qs[:, qsl])
        dq[:, qsl] = dq_acc * scale
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def lowrank_matmul_bwd_ref(x, A, B, xa, dy):
    """(dx, dA, dB) of y = (x @ A) @ B, given the forward's rounded ``xa``:
    d(xa) = dy B^T, dB = xa^T dy, dA = x^T d(xa), dx = d(xa) A^T, each
    product on fp32 copies and rounded to its primal's dtype (d(xa) to x's,
    then read back as fp32), where the reference's autodiff of
    ``kernels/ref.py::lowrank_matmul_ref`` rounds.  Stacked operands
    (L, ...) batch over L."""
    g = dy.float()
    dxa = torch.matmul(g, B.float().transpose(-1, -2)).to(xa.dtype)
    dB = torch.matmul(xa.float().transpose(-1, -2), g).to(B.dtype)
    g2 = dxa.float()
    dx = torch.matmul(g2, A.float().transpose(-1, -2)).to(x.dtype)
    dA = torch.matmul(x.float().transpose(-1, -2), g2).to(A.dtype)
    return dx, dA, dB


LOGITS_BWD_ROWS = 16384  # vocab rows of the head upcast at a time in the logits backward


def logits_bwd_ref(x2, table, dlogits, *, tied: bool):
    """(dx, dtable) of the fp32 logits ``x2 @ table.T`` (tied, table (V, d))
    or ``x2 @ table`` (untied head (d, V)): dx = dlogits table (or head^T)
    and dtable = dlogits^T x2 (dhead = x2^T dlogits), fp32 products rounded
    to x's and the table's dtypes, as the reference's transpose of its
    ``preferred_element_type=f32`` matmul rounds.

    The fp32 cotangent meets the bf16 table one block of
    :data:`LOGITS_BWD_ROWS` vocab rows at a time: only that block is upcast
    (128 MB fp32 at d 2048), never the whole table (1 GB at llama3.2-1b's
    128256 x 2048), and dx sums the blocks' fp32 products in vocab order."""
    d = x2.shape[-1]
    V = table.shape[0] if tied else table.shape[1]
    x32 = x2.float()
    dx = torch.zeros((x2.shape[0], d), dtype=torch.float32, device=x2.device)
    dtable = torch.empty_like(table)
    for v0 in range(0, V, LOGITS_BWD_ROWS):
        vs = slice(v0, min(V, v0 + LOGITS_BWD_ROWS))
        g = dlogits[:, vs]
        if tied:
            dx += torch.matmul(g, table[vs].float())
            dtable[vs] = torch.matmul(g.T, x32).to(table.dtype)
        else:
            dx += torch.matmul(g, table[:, vs].float().T)
            dtable[:, vs] = torch.matmul(x32.T, g).to(table.dtype)
    return dx.to(x2.dtype), dtable


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
