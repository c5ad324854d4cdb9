"""Optimizers from scratch: AdamW, Adafactor, SGD-momentum.

The port's counterpart of ``repro/train/optimizer.py``, over nested dicts
of tensors (the port's params trees).  Minimal optax-like contract:
``Optimizer(init, update)``; ``update(grads, state, params, step)`` returns
``(updates, new_state)`` and :func:`apply_updates` adds them.  Gradients
come from torch autograd; the optimizers only read them.

Adafactor keeps factored second moments for >=2-D leaves (row/col
statistics).  All moment math runs in fp32 whatever the param dtype, and the
schedules return 0-d fp32 tensors, as the reference computes them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple

import torch

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgdm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_schedule",
    "constant_schedule",
    "global_norm",
    "apply_updates",
]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (grads, state, params, step)


def _map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (nested dicts), each with the subtrees
    of ``rest`` at the same path (a leaf's optimizer state may be a dict)."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _part(tree, i: int):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


def _tensor_leaves(tree):
    if isinstance(tree, Mapping):
        for k in tree:
            yield from _tensor_leaves(tree[k])
    else:
        yield tree


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in _tensor_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply_updates(params, updates):
    return _map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


# --------------------------------------------------------------------------- #
# schedules: step (int or tensor) -> 0-d fp32 learning rate
# --------------------------------------------------------------------------- #
def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_schedule(lr: float, warmup: int, total: int):
    def fn(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        decay = torch.clamp((total - s) / max(total - warmup, 1), min=0.0)
        return lr * torch.minimum(warm, decay)

    return fn


def cosine_schedule(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return fn


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def adamw(lr: Callable, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params)}

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        lr_t = lr(step)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t

        def upd(g, m, v, p):
            g32 = g.float()
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * torch.square(g32)
            u = -lr_t * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
            if weight_decay and p.dim() >= 2:  # decay matrices only (not norms/biases/scalars)
                u = u - lr_t * weight_decay * p.float()
            return u, m2, v2

        outs = _map(upd, grads, state["m"], state["v"], params)
        return _part(outs, 0), {"m": _part(outs, 1), "v": _part(outs, 2)}

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# Adafactor (factored second moments; Shazeer & Stern 2018)
# --------------------------------------------------------------------------- #
def adafactor(lr: Callable, *, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),  # row stats
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return _map(leaf, params)

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        beta = 1.0 - t**-decay
        lr_t = lr(step)

        def upd(g, s, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.mean(vr, dim=-1, keepdim=True)
                rhat = (vr / torch.clamp(denom, min=eps))[..., None]
                u = g32 * torch.rsqrt(rhat * vc[..., None, :] + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr_t * u
            if weight_decay and p.dim() >= 2:
                u = u - lr_t * weight_decay * p.float()
            return u, new_s

        outs = _map(upd, grads, state, params)
        return _part(outs, 0), _part(outs, 1)

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# SGD + momentum
# --------------------------------------------------------------------------- #
def sgdm(lr: Callable, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    def update(grads, state, params, step):
        lr_t = lr(step)

        def upd(g, m):
            g32 = g.float()
            m2 = momentum * m + g32
            u = -(lr_t * (g32 + momentum * m2)) if nesterov else -(lr_t * m2)
            return u, m2

        outs = _map(upd, grads, state)
        return _part(outs, 0), _part(outs, 1)

    return Optimizer(init, update)
