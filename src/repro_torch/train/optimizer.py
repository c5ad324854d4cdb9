"""Optimizers from scratch: AdamW, Adafactor, SGD-momentum.

The port's counterpart of ``repro/train/optimizer.py``, over nested dicts
of tensors (the port's params trees).  Minimal optax-like contract:
``Optimizer(init, update)``; ``update(grads, state, params, step)`` returns
``(updates, new_state)`` and :func:`apply_updates` adds them.  Gradients
come from torch autograd; the optimizers only read them.

Adafactor keeps factored second moments for >=2-D leaves (row/col
statistics).  All moment math runs in fp32 whatever the param dtype, and the
schedules return 0-d fp32 tensors, as the reference computes them.

On blocks (the tensor-parallel train step passes ``specs=``, the params'
layout spec tree, under rules on a live mesh) AdamW and SGD-momentum are
elementwise and need nothing; Adafactor's factored statistics are means
over a param's last two dims, so where one of them is split its mean is
pmean'd over the axes that split it, and the update's RMS over the whole
leaf likewise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.runtime.distributed import pmean
from repro_torch.tree import tree_map as _map
from repro_torch.tree import tree_part as _part
from repro_torch.tree import tree_paths

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgdm",
    "clip_by_global_norm",
    "scale_by_norm",
    "cosine_schedule",
    "linear_schedule",
    "constant_schedule",
    "global_norm",
    "apply_updates",
]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (grads, state, params, step)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for _, x in tree_paths(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def scale_by_norm(grads, norm: torch.Tensor, max_norm: float):
    """The grads scaled to a global norm of at most ``max_norm``, given their norm."""
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    return scale_by_norm(grads, norm, max_norm), norm


def apply_updates(params, updates):
    """New params ``(p + u)`` in p's dtype.  Each result keeps its leaf's
    storage layout (``torch.empty_strided`` of p's strides): a factor leaf
    stored with its rows padded to 8 elements (``core.lowrank.lowrank_params``)
    stays so, and the kernels go on reading it in place, with no counted
    copy (``kernels/_build.py::ALIGN_COPIES``) on the next forward."""

    def upd(p, u):
        out = torch.empty_strided(p.shape, p.stride(), dtype=p.dtype, device=p.device)
        return out.copy_(p.float() + u.float())

    return _map(upd, params, updates)


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

    def update(grads, state, params, step, specs=None):
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

    def update(grads, state, params, step, specs=None):
        t = _f32(step) + 1.0
        beta = 1.0 - t**-decay
        lr_t = lr(step)
        mesh = None
        if specs is not None:
            from repro_torch.sharding.rules import tp_rules

            mesh = tp_rules().mesh

        def upd(g, s, p, spec=None):
            sp = tuple(spec or ()) + (None,) * (g.dim() - len(spec or ()))

            def over(x, dims):
                """A local mean, pmean'd over the axes that split the param's ``dims``."""
                for d in dims if mesh is not None else ():
                    x = pmean(x, sp[d], mesh)
                return x

            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * over(torch.mean(g2, dim=-1), (-1,))
                vc = beta * s["vc"] + (1 - beta) * over(torch.mean(g2, dim=-2), (-2,))
                denom = over(torch.mean(vr, dim=-1, keepdim=True), (-2,))
                rhat = (vr / torch.clamp(denom, min=eps))[..., None]
                u = g32 * torch.rsqrt(rhat * vc[..., None, :] + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(over(torch.mean(torch.square(u)), range(g.dim())) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr_t * u
            if weight_decay and p.dim() >= 2:
                u = u - lr_t * weight_decay * p.float()
            return u, new_s

        outs = _map(upd, grads, state, params) if specs is None else _map(upd, grads, state, params, specs)
        return _part(outs, 0), _part(outs, 1)

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# SGD + momentum
# --------------------------------------------------------------------------- #
def sgdm(lr: Callable, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    def update(grads, state, params, step, specs=None):
        lr_t = lr(step)

        def upd(g, m):
            g32 = g.float()
            m2 = momentum * m + g32
            u = -(lr_t * (g32 + momentum * m2)) if nesterov else -(lr_t * m2)
            return u, m2

        outs = _map(upd, grads, state)
        return _part(outs, 0), _part(outs, 1)

    return Optimizer(init, update)
