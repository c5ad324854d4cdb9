"""Mixture-of-Experts with sort-based capacity dispatch, and the dense FFN.

The port's counterpart of ``repro/models/moe.py``.  Tokens are routed in
fp32 (softmax, top-k, gates renormalized), sorted by expert id (a stable
sort, so each expert takes its tokens in token order), scattered into a
static ``(E, C, d)`` buffer (assignments past an expert's capacity C drop),
run through the experts as one batched product per projection, and
combined back with their gates in routing-rank order.  C comes from the static token count T
(:func:`moe_capacity`), so the layer reads no value back to the host and
captures into a CUDA graph as it is.

Compressed experts (``{"a": (E, d, r), "b": (E, r, f)}`` leaves) go through
``core.lowrank.apply_linear``, which dispatches the whole expert stack to
ONE call of the batched low-rank kernel; dense experts are a batched
``torch.matmul`` with fp32 accumulation (the reference leaves that product
to XLA as well).

Under active sharding rules on a live mesh with a ``"model"`` axis that
divides ``n_experts``, the layer runs expert-parallel
(:func:`_moe_expert_parallel`, the reference's ``shard_map`` path written
as per-rank code): each rank holds its block of the batch and its
``n_experts / model`` experts, and one sum over ``"model"`` combines them.
The two programs of ``sharding/rules.py`` differ only in where the experts
come from and how the sum leaves the layer.  In the whole-param program
(a ``moe_forward`` without ``tp``: the MLA archs) the experts are sliced
from the whole stacks and a psum combines them.  In the
tensor-parallel one (a ``tp`` layout from ``models/modules.py``) they are
stored as this rank's ``"ep"`` block, their ``d`` gathered over "data"
just before the products, the router and the shared experts follow the
linear rules, and the region's exit of the conjugate pair sums them.
"""

from __future__ import annotations

import torch

from repro_torch.core.lowrank import gather_blocks
from repro_torch.models import modules as nn
from repro_torch.runtime import distributed
from repro_torch.sharding.rules import active_rules, leaf_spec
from repro_torch.tree import tree_map

__all__ = ["moe_init", "moe_forward", "moe_apply", "ffn_init", "ffn_forward", "moe_capacity"]


def ffn_init(generator: torch.Generator, d: int, f: int, dtype, device) -> dict:
    return {
        "w_gate": nn.dense_init(generator, d, f, dtype, device),
        "w_up": nn.dense_init(generator, d, f, dtype, device),
        "w_down": nn.dense_init(generator, f, d, dtype, device, scale=f**-0.5),
    }


def ffn_forward(p, x: torch.Tensor, *, tp=None, d_ff=None, name: str = "mlp") -> torch.Tensor:
    """SwiGLU FFN.  Under ``tp`` (``d_ff`` its whole width, ``name`` its
    path under a layer) x is this rank's rows of the residual stream:
    w_gate / w_up column-parallel, w_down row-parallel out of the region."""
    if tp is None:
        g = nn.dense(p["w_gate"], x)
        u = nn.dense(p["w_up"], x)
        return nn.dense(p["w_down"], nn.swiglu(g, u))
    h = tp.enter(x)
    d = h.shape[-1]
    g = nn.tp_linear(tp, p["w_gate"], h, name + "/w_gate", (d, d_ff))
    u = nn.tp_linear(tp, p["w_up"], h, name + "/w_up", (d, d_ff))
    return nn.tp_linear(tp, p["w_down"], nn.swiglu(g, u), name + "/w_down", (d_ff, d), row=True)


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
    the (E*C, d) buffer, and the combine gathers each token's K expert rows
    back out of the (E*C, d) outputs.  Returns fp32 (T, d)."""
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
    occupied = _scatter_drop(E * C, slot, keep.float())

    buf = (xf[slot_tok].float() * occupied[:, None]).to(dtype).reshape(E, C, d)
    # (E, C, a) @ (E, a, b) per projection: a compressed stack is ONE batched
    # low-rank call (core.lowrank.apply_linear -> dispatch), a dense one a
    # batched matmul
    h = nn.swiglu(nn.dense(experts["w_gate"], buf), nn.dense(experts["w_up"], buf))
    y = nn.dense(experts["w_down"], h).reshape(E * C, d)

    # The reference's .at[slot_tok].add, as a fixed-order combine: each token
    # gathers its K weighted expert rows, (T, K, d) fp32 (a dropped
    # assignment is an exact 0.0, whatever its clamped row holds), and sums
    # them in routing-rank order k = 0..K-1.  No atomics and no dependence
    # on slot order, so graph == eager and paged == flat hold bit for bit at
    # any top-k; at top-2 it gives the bits of a scatter-add into zeros,
    # since 0 + a + b == 0 + b + a exactly.
    picked = y[torch.clamp(slot, max=E * C - 1)].float() * gates.reshape(-1, 1).float()
    rows = torch.where(keep[:, None], picked, torch.zeros((), dtype=torch.float32, device=dev)).reshape(T, K, d)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for k in range(K):
        out = out + rows[:, k]
    return out


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


def _local_experts(experts, E: int, E_loc: int, j: int):
    """Rank j's E_loc experts, sliced (views) from the whole (E, ...) stacks."""
    def one(w):
        if w.shape[0] != E:
            raise ValueError(f"expert stack of {w.shape[0]}: the expert-parallel layer takes all {E}")
        return w[j * E_loc:(j + 1) * E_loc]
    return tree_map(one, experts)


def _moe_expert_parallel(xf, gate_w, experts, cfg, mesh, j: int, *, with_aux: bool, enter=None):
    """The expert-parallel layer's body on this rank (the reference's
    ``shard_map`` path written as per-rank code), for both programs.

    ``xf`` (T, d): this rank's tokens (its block of the batch, the same on
    every rank of "model"); ``gate_w`` the whole router weight;
    ``experts`` this rank's ``E / m`` experts, each with its full inner
    dims, ``j`` its index along "model".  Each rank routes its tokens
    (redundantly over "model": a d x E product), keeps the assignments to
    its own experts (the rest take the drop sentinel E_loc) and runs its
    expert stack through the batched path (one call of the batched low-rank
    kernel when compressed).  The local capacity counts the tokens of ONE
    batch shard to ONE expert, with more slack than the global rule (x 1.6)
    because local loads vary more.  The aux loss is this shard's, pmean'd
    over the batch axes (a per-shard estimator, close to the single-device
    loss, not equal; None without ``with_aux``).  ``enter`` maps the tokens
    and gates into the experts' region (the tensor-parallel program's
    conjugate copy).  Returns (each token's fp32 sum of its top-k outputs
    from this rank's experts, aux): the caller sums it over "model"."""
    E_loc = cfg.n_experts // mesh.shape.get("model", 1)
    T = xf.shape[0]
    C = int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor * 1.6)
    C = max(((C + 127) // 128) * 128, 128)
    ids, gates, probs = _route(xf, gate_w, cfg)
    aux = _aux_loss(probs, ids, cfg) if with_aux else None
    for a in ("pod", "data") if with_aux else ():
        if a in mesh.shape:
            aux = distributed.pmean(aux, a, mesh)
    lo = j * E_loc
    local = torch.where((ids >= lo) & (ids < lo + E_loc), ids - lo, torch.full_like(ids, E_loc))
    if enter is not None:
        xf, gates = enter(xf), enter(gates)
    return _dispatch_compute_combine(xf, local, gates, experts, C, E_loc, xf.dtype), aux


def _expert_parallel(cfg):
    """The active rules where the layer runs expert-parallel, else None."""
    rules = active_rules()
    if (rules is not None and "model" in rules.mesh.shape
            and cfg.n_experts % rules.mesh.shape["model"] == 0):
        return rules
    return None


def _moe_tp(p, x: torch.Tensor, cfg, tp, *, with_aux: bool):
    """The layer in the tensor-parallel program: x is this rank's rows of
    the residual stream, the experts this rank's ``"ep"`` block, their
    ``d`` gathered over "data" just before the products.  Every rank
    routes every row of its batch block (full cotangents: the rows gathered
    with a sliced backward, the router's ``d`` gathered over "data"), its
    experts take the copies of the rows and gates that enter the region,
    and the exit sums the combine over "model", reduce-scattered onto the
    sequence where it lies over "model"."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    if E % tp.size:
        raise ValueError(f"the tensor-parallel MoE layer needs n_experts {E} to divide over \"model\" ({tp.size})")
    xw = tp.whole(x)
    B, S, _ = xw.shape
    gate_w = gather_blocks(p["router"]["gate_w"], leaf_spec("moe/router/gate_w", (d, E)), tp.mesh)
    shapes = {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}
    experts = {k: gather_blocks(w, leaf_spec("moe/experts/" + k, shapes[k]), tp.mesh)
               for k, w in p["experts"].items()}
    out, aux = _moe_expert_parallel(xw.reshape(B * S, d), gate_w, experts, cfg, tp.mesh, tp.index,
                                    with_aux=with_aux, enter=tp.copy)
    out = tp.exit(out.reshape(B, S, d)).to(x.dtype)
    if "shared" in p:
        out = out + ffn_forward(p["shared"], x, tp=tp, d_ff=cfg.n_shared_experts * f, name="moe/shared")
    return out, aux


def _moe(p, x: torch.Tensor, cfg, *, with_aux: bool, tp=None):
    if tp is not None:
        return _moe_tp(p, x, cfg, tp, with_aux=with_aux)
    rules = _expert_parallel(cfg)
    if rules is None:
        out, ids, probs = _moe_local(p, x, cfg)
        return out, (_aux_loss(probs, ids, cfg) if with_aux else None)
    mesh = rules.mesh
    B, S, d = x.shape
    j = distributed.axis_index("model", mesh)
    experts = _local_experts(p["experts"], cfg.n_experts, cfg.n_experts // mesh.shape["model"], j)
    out, aux = _moe_expert_parallel(x.reshape(B * S, d), p["router"]["gate_w"], experts, cfg, mesh, j,
                                    with_aux=with_aux)
    out = distributed.psum(out, "model", mesh).to(x.dtype).reshape(B, S, d)
    if "shared" in p:
        out = out + ffn_forward(p["shared"], x)
    return out, aux


def moe_apply(p, x: torch.Tensor, cfg, *, tp=None) -> torch.Tensor:
    """x: (B, S, d) -> out, without the load-balance loss: the serving
    paths discard it, so they do not launch its kernels."""
    return _moe(p, x, cfg, with_aux=False, tp=tp)[0]


def moe_forward(p, x: torch.Tensor, cfg, *, tp=None):
    """x: (B, S, d).  Returns (out, aux_loss)."""
    return _moe(p, x, cfg, with_aux=True, tp=tp)
