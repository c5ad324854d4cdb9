"""Mixture-of-Experts with sort-based capacity dispatch, and the dense FFN.

The port's counterpart of ``repro/models/moe.py``.  Tokens are routed in
fp32 (softmax, top-k, gates renormalized), sorted by expert id (a stable
sort, so each expert takes its tokens in token order), scattered into a
static ``(E, C, d)`` buffer (assignments past an expert's capacity C drop),
run through the experts as one batched product per projection, and
combined back with their gates.  C comes from the static token count T
(:func:`moe_capacity`), so the layer reads no value back to the host and
captures into a CUDA graph as it is.

Compressed experts (``{"a": (E, d, r), "b": (E, r, f)}`` leaves) go through
``core.lowrank.apply_linear``, which dispatches the whole expert stack to
ONE call of the batched low-rank kernel; dense experts are a batched
``torch.matmul`` with fp32 accumulation (the reference leaves that product
to XLA as well).

The reference's expert-parallel ``shard_map`` path (``_moe_expert_parallel``)
is not ported: the port has no mesh yet.
"""

from __future__ import annotations

import torch

from repro_torch.models import modules as nn

__all__ = ["moe_init", "moe_forward", "moe_apply", "ffn_init", "ffn_forward", "moe_capacity"]


def ffn_init(generator: torch.Generator, d: int, f: int, dtype, device) -> dict:
    return {
        "w_gate": nn.dense_init(generator, d, f, dtype, device),
        "w_up": nn.dense_init(generator, d, f, dtype, device),
        "w_down": nn.dense_init(generator, f, d, dtype, device, scale=f**-0.5),
    }


def ffn_forward(p, x: torch.Tensor) -> torch.Tensor:
    g = nn.dense(p["w_gate"], x)
    u = nn.dense(p["w_up"], x)
    return nn.dense(p["w_down"], nn.swiglu(g, u))


def moe_init(generator: torch.Generator, cfg, dtype, device) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": {"gate_w": nn.dense_init(generator, d, E, dtype, device, scale=d**-0.5)},
        "experts": {
            "w_gate": _expert_init(generator, E, d, f, dtype, device),
            "w_up": _expert_init(generator, E, d, f, dtype, device),
            "w_down": _expert_init(generator, E, f, d, dtype, device),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(generator, d, cfg.n_shared_experts * f, dtype, device)
    return p


def _expert_init(generator: torch.Generator, E: int, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    w = torch.randn((E, d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return (w * d_in**-0.5).to(dtype)


def moe_capacity(tokens: int, cfg) -> int:
    """Rows per expert for a call that sees ``tokens`` rows (padding and
    idle engine slots included, as in the reference): the capacity-factor
    share, rounded up to a multiple of 128, at least 128."""
    cap = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(((cap + 127) // 128) * 128, 128)


def _route(xf: torch.Tensor, gate_w: torch.Tensor, cfg):
    """fp32 routing: (expert ids (T, K), normalized gates (T, K), probs (T, E)).

    ``jax.lax.top_k`` breaks ties toward the lower expert index;
    ``torch.topk`` promises no order among equal values.  An exact tie of
    two fp32 softmax probabilities is vanishingly rare on real activations,
    so the parity tests do not meet one.
    """
    K = cfg.top_k
    logits = torch.matmul(xf.float(), gate_w.float())
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, gate_ids = torch.topk(probs, K, dim=-1)  # (T, K), descending
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_ids, gate_vals, probs


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, cfg) -> torch.Tensor:
    """The reference's load-balance loss E * sum(mean probs * assignment share)."""
    E = cfg.n_experts
    me = probs.mean(dim=0)
    # the share of assignments each expert takes: mean over tokens of the
    # summed one-hot rows, as a scatter-add of ones (one_hot may check its
    # input on the host)
    ce = torch.zeros((E,), dtype=torch.float32, device=ids.device).index_add_(
        0, ids.reshape(-1), torch.ones((ids.numel(),), dtype=torch.float32, device=ids.device))
    ce = ce / ids.shape[0]
    return E * torch.sum(me * ce)


def _scatter_drop(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[index].set(values, mode="drop")`` for indices in [0, n]:
    index n is the drop slot, one dump row past the end that is sliced off
    (kept indices are unique, so only the dump row sees duplicates)."""
    out = torch.zeros((n + 1,), dtype=values.dtype, device=values.device)
    out[index] = values
    return out[:n]


def _dispatch_compute_combine(xf, ids, gates, experts, C: int, E: int, dtype):
    """Capacity dispatch -> batched expert products -> weighted combine.

    xf (T, d); ids / gates (T, K).  Routing metadata stays 1-D; activations
    exist only at capacity size: a slot -> token map gathers straight into
    the (E*C, d) buffer, and the combine adds the (E*C, d) expert outputs
    back into (T, d).  Returns fp32 (T, d)."""
    T, d = xf.shape
    K = ids.shape[-1]
    dev = xf.device
    ids_flat = ids.reshape(-1)  # (T*K,)
    order = torch.argsort(ids_flat, stable=True)  # jnp.argsort is stable: token order within an expert
    sorted_ids = ids_flat[order]
    seg_start = torch.searchsorted(sorted_ids, torch.arange(E, device=dev, dtype=sorted_ids.dtype))
    pos_sorted = torch.arange(T * K, device=dev) - seg_start[torch.clamp(sorted_ids, max=E - 1)]
    pos_flat = torch.empty_like(pos_sorted)
    pos_flat[order] = pos_sorted

    keep = (pos_flat < C) & (ids_flat < E)
    slot = torch.where(keep, ids_flat * C + pos_flat, torch.full_like(ids_flat, E * C))  # E*C == drop
    tok_idx = torch.arange(T * K, device=dev) // K

    slot_tok = _scatter_drop(E * C, slot, tok_idx)
    slot_gate = _scatter_drop(E * C, slot, gates.reshape(-1).float())
    occupied = _scatter_drop(E * C, slot, keep.float())

    buf = (xf[slot_tok].float() * occupied[:, None]).to(dtype).reshape(E, C, d)
    # (E, C, a) @ (E, a, b) per projection: a compressed stack is ONE batched
    # low-rank call (core.lowrank.apply_linear -> dispatch), a dense one a
    # batched matmul
    h = nn.swiglu(nn.dense(experts["w_gate"], buf), nn.dense(experts["w_up"], buf))
    y = nn.dense(experts["w_down"], h).reshape(E * C, d)

    weighted = y.float() * (slot_gate * occupied)[:, None]  # (E*C, d)
    # The reference's .at[slot_tok].add.  On the card index_add_ adds with
    # atomics in no fixed order, yet the sum is still bit-reproducible: a
    # token receives at most top_k = 2 non-zero terms (every empty slot maps
    # to token 0 with an exact zero), and 0 + a + b == 0 + b + a exactly.
    # The paged == flat and graph == eager token gates on the card rest on
    # this; a top-k of 3 or more needs a fixed-order combine.
    return torch.zeros((T, d), dtype=torch.float32, device=dev).index_add_(0, slot_tok, weighted)


def _moe_local(p, x: torch.Tensor, cfg):
    """The single-device path: x (B, S, d) -> ((B, S, d), ids, probs)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    ids, gates, probs = _route(xf, p["router"]["gate_w"], cfg)
    C = moe_capacity(T, cfg)  # from the static shape: nothing read back from the device
    out = _dispatch_compute_combine(xf, ids, gates, p["experts"], C, cfg.n_experts, x.dtype).to(x.dtype)
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + ffn_forward(p["shared"], x)
    return out, ids, probs


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> out, without the load-balance loss: the serving
    paths discard it, so they do not launch its kernels."""
    return _moe_local(p, x, cfg)[0]


def moe_forward(p, x: torch.Tensor, cfg):
    """x: (B, S, d).  Returns (out, aux_loss)."""
    out, ids, probs = _moe_local(p, x, cfg)
    return out, _aux_loss(probs, ids, cfg)
