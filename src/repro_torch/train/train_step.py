"""Train-step builders: loss, gradients, optimizer apply.

The port's counterpart of ``repro/train/train_step.py``.  The returned step
function has the signature ``train_step(state, batch) -> (state, metrics)``
and leaves its input state untouched.  Features, as the reference's:

  * cross-entropy over the PADDED vocab with the padding columns masked,
    optional z-loss, the head applied per sequence chunk
    (:func:`chunked_softmax_xent`) so that the full fp32 logits never exist;
  * the MoE auxiliary load-balance loss folded in at ``aux_weight``;
  * global-norm gradient clipping;
  * gradient accumulation over ``accum_steps`` microbatches, summed in fp32
    in microbatch order.

Gradients come from torch autograd: every hand-written kernel a training
forward reaches runs through its ``torch.autograd.Function``
(``runtime/dispatch.py``), so the factor leaves of an RSI-compressed model
and everything upstream of an attention call get their gradients on the
card as on the CPU.  The forward and the optimizer run under the profiler
ranges ``train_step.forward`` and ``train_step.optimizer`` (the backward
shows as autograd's own ranges).  Under ``rules=`` the step runs inside
``use_rules``, and :func:`state_specs` gives a TrainState's spec tree.
Where ``rules.mesh`` is a live mesh (``runtime/distributed.py``), the step
is one rank's, in one of two programs:

* The tensor-parallel one (the families that
  ``sharding.rules.tensor_parallel`` names; ``specs=`` the params' layout
  spec tree, ``sharding.rules.layout_specs`` of the whole params): the
  state holds this rank's blocks of the params and of the optimizer
  moments, the forward runs on them, and the cross-entropy runs over
  vocab-parallel logits (the max and the sum of exponentials reduced over
  "model", the gold logit from the rank that holds it).  In Megatron's
  convention (``runtime/distributed.py``) a rank's backward gives the
  gradient of its "data" row's loss; the gradient mean runs over the
  batch axes ("pod", "data") only, an FSDP leaf's through the reduce-scatter
  of its gather's backward.  The global norm counts each element of a
  leaf once, however many ranks hold a replica of it, and the optimizer
  updates the blocks (Adafactor's factored means reduced over the axes
  that split them).
* The whole-param one (any other family: MLA, the SSM leaves, the vlm
  and the encoder-decoder): every rank holds the whole params and its block of the
  batch (split over the batch axes, the same block along "model"), the MoE
  layers run expert-parallel, and the gradients, the loss and the aux
  loss are averaged over the world before clipping.  With the psums'
  backward that is the gradient of the whole batch's loss.

Either is the reference's step under its rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime import dispatch
from repro_torch.runtime.distributed import Mesh, axis_names, pmax, pmean, psum, tp_reduce
from repro_torch.sharding.rules import MeshRules, param_specs, tensor_parallel, use_rules
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_from_paths, tree_map, tree_paths

__all__ = ["TrainState", "make_train_step", "loss_and_grads", "softmax_xent", "chunked_softmax_xent",
           "init_train_state", "state_specs", "tp_grad_mean", "tp_global_norm", "tree_paths", "tree_from_paths"]

NEG_INF = -1e30


@dataclasses.dataclass
class TrainState:
    """params and opt_state are nested dicts of tensors; step is a 0-d int32
    tensor kept on the host (the schedules read it without a device sync)."""

    params: Any
    opt_state: Any
    step: torch.Tensor


def _mask_padded(logits: torch.Tensor, real_vocab: int) -> torch.Tensor:
    Vp = logits.shape[-1]
    if real_vocab >= Vp:
        return logits
    pad = torch.arange(Vp, device=logits.device) >= real_vocab
    return torch.where(pad, torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device), logits)


def _lse_gold(logits: torch.Tensor, targets: torch.Tensor, real_vocab: int, tp=None):
    """(log-sum-exp, gold logit) of each row.  Under ``tp`` the logits are
    this rank's vocab block: the max and the sum of exponentials are
    reduced over "model", and the gold logit comes from the rank whose
    block holds the target (the others add zeros)."""
    if tp is None:
        logits = _mask_padded(logits, real_vocab)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return lse, gold
    n = logits.shape[-1]
    lo = tp.index * n
    col = lo + torch.arange(n, device=logits.device)
    logits = torch.where(col >= real_vocab, torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device),
                         logits)
    m = pmax(logits.detach().amax(dim=-1), "model", tp.mesh)
    se = tp_reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1), "model", tp.mesh)
    lse = m + torch.log(se)
    t = targets.long() - lo
    mine = (t >= 0) & (t < n)
    g = torch.gather(logits, -1, torch.clamp(t, 0, n - 1)[..., None])[..., 0]
    gold = tp_reduce(torch.where(mine, g, torch.zeros_like(g)), "model", tp.mesh)
    return lse, gold


def softmax_xent(logits, targets, *, real_vocab: int, z_loss: float = 1e-4, tp=None):
    """logits fp32 (..., Vp); targets int (...).  Padded vocab masked."""
    lse, gold = _lse_gold(logits, targets, real_vocab, tp)
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def chunked_softmax_xent(feats, targets, head_apply, *, real_vocab: int, z_loss: float = 1e-4,
                         n_chunks: int = 16, tp=None):
    """The head and the cross-entropy fused over sequence chunks.

    feats (B, S, d); ``head_apply(x) -> fp32 logits``.  ``n_chunks`` is halved
    until it divides S (to 1: the plain :func:`softmax_xent`).  Each chunk's
    head runs under ``torch.utils.checkpoint``, so only one chunk's (B, S/n,
    Vp) fp32 logits are alive and the backward recomputes them: one extra
    head product a chunk for ~n x less peak memory (the full logits of
    llama3.2-1b at batch 8 x 256 are 1 GiB).  The sums over chunks run in
    chunk order, as the reference's scan carry.  Under ``tp`` (tensor-parallel
    rules) the head gives this rank's vocab block (:func:`_lse_gold`)."""
    B, S, d = feats.shape
    while S % n_chunks:
        n_chunks //= 2
    if n_chunks <= 1:
        return softmax_xent(head_apply(feats), targets, real_vocab=real_vocab, z_loss=z_loss, tp=tp)
    xf = feats.reshape(B, n_chunks, S // n_chunks, d).transpose(0, 1)
    tf = targets.reshape(B, n_chunks, S // n_chunks).transpose(0, 1)

    def body(x_c, t_c):
        lse, gold = _lse_gold(head_apply(x_c), t_c, real_vocab, tp)
        return torch.sum(lse - gold), torch.sum(torch.square(lse))

    body = dispatch.bound_to_dispatch(body)  # the recomputation in the backward takes the forward's paths
    sl = sz = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(n_chunks):
        if torch.is_grad_enabled():
            a, b = checkpoint(body, xf[i], tf[i], use_reentrant=False)
        else:
            a, b = body(xf[i], tf[i])
        sl, sz = sl + a, sz + b
    n_tok = B * S
    loss = sl / n_tok
    if z_loss:
        loss = loss + z_loss * sz / n_tok
    return loss


def init_train_state(model, optimizer: opt_mod.Optimizer, generator: torch.Generator) -> TrainState:
    params = model.init(generator)
    return TrainState(params=params, opt_state=optimizer.init(params), step=torch.zeros((), dtype=torch.int32))


def state_specs(state: TrainState, rules: MeshRules) -> TrainState:
    """The spec tree of a TrainState: each optimizer moment takes its
    param's spec (AdamW's m / v and SGD-momentum's mirror the params);
    Adafactor's factored statistics take the param's spec without the
    reduced axis (``vr`` drops the last entry, ``vc`` the one before it);
    the step is replicated."""
    p_specs = param_specs(state.params, rules)

    def walk(o, s):
        if isinstance(o, dict) and set(o) == {"vr", "vc"} and not isinstance(s, dict):
            parts = tuple(s) if s is not None else ()
            vr = parts[:-1] if parts else ()
            vc = parts[:-2] + parts[-1:] if len(parts) >= 2 else ()
            return {"vr": vr, "vc": vc}
        if isinstance(o, dict) and set(o) == {"v"} and not isinstance(s, dict):
            return {"v": s if s is not None else ()}
        if isinstance(o, dict):
            if isinstance(s, dict) and set(o) <= set(s):
                return {k: walk(v, s[k]) for k, v in o.items()}
            # AdamW's top level {"m": <params tree>, "v": <params tree>}
            return {k: walk(v, s) for k, v in o.items()}
        return s if s is not None else ()

    return TrainState(params=p_specs, opt_state=walk(state.opt_state, p_specs), step=())


def loss_and_grads(model, params, batch, *, aux_weight: float = 0.01, z_loss: float = 1e-4):
    """(grads, loss, aux) of one (micro)batch: the loss is the chunked
    cross-entropy of ``model.forward_features`` under ``model.head_apply``
    plus ``aux_weight`` x the aux loss, and every floating leaf of params
    gets its gradient (zeros where the loss does not reach it), in the
    leaf's dtype.  ``loss`` and ``aux`` come back as 0-d fp32 tensors."""
    from repro_torch.models.modules import tensor_parallel as tp_layout

    paths, leaves = zip(*tree_paths(params))
    live = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    tree = tree_from_paths(zip(paths, live))
    tp = tp_layout() if tensor_parallel(model.cfg) else None
    with torch.enable_grad(), record_function("train_step.forward"):
        feats, aux = model.forward_features(tree, batch)
        head = model.head_params(tree) if model.head_params is not None else tree
        loss = chunked_softmax_xent(feats, batch["targets"], lambda x: model.head_apply(head, x),
                                    real_vocab=model.cfg.vocab, z_loss=z_loss, tp=tp)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + aux_weight * aux
    wrt = [t for t in live if t.requires_grad]
    got = iter(torch.autograd.grad(total, wrt, allow_unused=True))
    grads = [(next(got) if t.requires_grad else None) for t in live]
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return tree_from_paths(zip(paths, grads)), loss.detach(), aux.detach()


def _split_axes(spec) -> set:
    return {a for e in (spec or ()) for a in axis_names(e)}


def tp_grad_mean(grads, specs, mesh):
    """The gradient mean of the tensor-parallel program: over each batch
    axis ("pod", "data"), a pmean where the leaf is whole along it, a
    division by its size where it is split along it (the gather's
    reduce-scatter already summed it)."""
    batch = [a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1]

    def one(g, spec):
        split = _split_axes(spec)
        g32 = g.float()
        for a in batch:
            g32 = g32 / mesh.shape[a] if a in split else pmean(g32, a, mesh)
        return g32.to(g.dtype)

    return tree_map(one, grads, specs)


def tp_global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of a tree of blocks: each leaf's sum of squares
    counted on the ranks at index 0 of every axis the leaf is whole along
    (each element once), summed over the mesh."""
    total = None
    for (_, g), (_, spec) in zip(tree_paths(grads), tree_paths(specs)):
        split = _split_axes(spec)
        keep = all(mesh.coords[a] == 0 for a in mesh.axes if a not in split)
        sq = torch.sum(torch.square(g.float())) * (1.0 if keep else 0.0)
        total = sq if total is None else total + sq
    return torch.sqrt(psum(total, mesh.axes, mesh))


def make_train_step(model, optimizer: opt_mod.Optimizer, *, rules: Optional[MeshRules] = None, accum_steps: int = 1,
                    max_grad_norm: float = 1.0, aux_weight: float = 0.01, z_loss: float = 1e-4, specs=None):
    """The step of ``model`` (a ``models.model.ModelApi``) under ``optimizer``
    (and ``rules``, active through the step).  Metrics: ``loss`` (the
    cross-entropy, z-loss included), ``aux_loss`` and ``grad_norm`` (before
    clipping), as 0-d fp32 tensors.  ``specs``: the params' layout spec
    tree, which the tensor-parallel program needs (the module docstring)."""

    def grads_of(params, batch):
        return loss_and_grads(model, params, batch, aux_weight=aux_weight, z_loss=z_loss)

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grads_of(params, batch)
        # microbatches: the batch dim must divide accum_steps
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        lsum = asum = 0.0
        for i in range(accum_steps):
            grads, loss, aux = grads_of(params, {k: v[i] for k, v in micro.items()})
            acc = tree_map(lambda a, g: a + g.float(), acc, grads)
            lsum, asum = lsum + loss, asum + aux
        return tree_map(lambda a: a / accum_steps, acc), lsum / accum_steps, asum / accum_steps

    live = rules is not None and isinstance(rules.mesh, Mesh)
    sharded = live and tensor_parallel(model.cfg)
    if sharded and specs is None:
        raise ValueError("the tensor-parallel step needs specs=: sharding.rules.layout_specs of the whole params")
    world = rules.mesh.axes if live else None
    batch_axes = tuple(a for a in ("pod", "data") if live and a in rules.mesh.shape)

    def world_mean(t):
        return pmean(t.float(), world, rules.mesh).to(t.dtype)

    def batch_mean(t):
        return pmean(t.float(), batch_axes, rules.mesh).to(t.dtype)

    def train_step(state: TrainState, batch):
        with use_rules(rules):
            grads, loss, aux = compute_grads(state.params, batch)
            if sharded:  # Megatron's convention: the mean over the batch axes only
                with torch.no_grad():
                    grads = tp_grad_mean(grads, specs, rules.mesh)
                    loss, aux = batch_mean(loss), batch_mean(aux)
            elif world is not None:  # the mean over the ranks' losses: see the module docstring
                with torch.no_grad():
                    grads, loss, aux = tree_map(world_mean, grads), world_mean(loss), world_mean(aux)
            with torch.no_grad(), record_function("train_step.optimizer"):
                if sharded:
                    gnorm = tp_global_norm(grads, specs, rules.mesh)
                    grads = opt_mod.scale_by_norm(grads, gnorm, max_grad_norm)
                    updates, opt_state = optimizer.update(grads, state.opt_state, state.params, state.step,
                                                          specs=specs)
                else:
                    grads, gnorm = opt_mod.clip_by_global_norm(grads, max_grad_norm)
                    updates, opt_state = optimizer.update(grads, state.opt_state, state.params, state.step)
                params = opt_mod.apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, {"loss": loss, "aux_loss": aux, "grad_norm": gnorm}

    return train_step
