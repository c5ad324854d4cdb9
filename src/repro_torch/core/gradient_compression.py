"""RSI-PowerSGD: low-rank compression of the data-parallel gradient all-reduce.

The port's counterpart of ``repro/core/gradient_compression.py``.  Instead
of all-reducing whole gradient matrices G (C x D), each data-parallel rank
sketches its gradient into rank-r factors with ONE warm-started subspace
iteration (Alg 3.1 at q = 1 with Omega carried over from the previous
step), and only the factors are all-reduced:

    comm per matrix: O((C + D) r)   against   O(C D)

Error feedback (Karimireddy et al.) keeps the compressed optimizer unbiased
in the long run: the residual G - P Q^T is added back into the next step's
gradient before sketching.  ``axis_name`` is a named axis of the active
mesh (``runtime/distributed.py``), or None (the psum is the identity).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.runtime.distributed import pmean
from repro_torch.tree import tree_map, tree_part, tree_paths

__all__ = ["PowerSGDConfig", "PowerSGDState", "init_powersgd", "compress_allreduce", "comm_bytes"]


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_size: int = 65536  # tensors smaller than this are all-reduced densely
    ef: bool = True  # error feedback


def _is_matrix(x: torch.Tensor) -> bool:
    return x.dim() >= 2 and x.shape[-1] > 1 and x.shape[-2] > 1


def _compressed(g: torch.Tensor, cfg: PowerSGDConfig) -> bool:
    return _is_matrix(g) and g.numel() >= cfg.min_size


@dataclasses.dataclass
class PowerSGDState:
    """Per-leaf warm Q factors and error-feedback residuals (None where a
    leaf is all-reduced densely), trees parallel to the gradients."""

    qs: Any
    errors: Any


def init_powersgd(grads: Any, cfg: PowerSGDConfig = PowerSGDConfig(), *,
                  generator: Optional[torch.Generator] = None, qs: Any = None) -> PowerSGDState:
    """Warm factors Q (..., D, r) fp32 for every compressed leaf: ``qs`` as
    given (a tree parallel to ``grads``, the tests hand in the reference's),
    or Gaussian from ``generator``, leaf by leaf in tree order."""

    def init_leaf(g, q=None):
        if not _compressed(g, cfg):
            return None
        if q is not None:
            return torch.as_tensor(q, dtype=torch.float32, device=g.device)
        if generator is None:
            raise ValueError("init_powersgd needs generator= or qs=")
        r = min(cfg.rank, min(g.shape[-2], g.shape[-1]))
        return torch.randn(tuple(g.shape[:-2]) + (g.shape[-1], r), generator=generator, dtype=torch.float32,
                           device=g.device)

    q_tree = tree_map(init_leaf, grads) if qs is None else tree_map(init_leaf, grads, qs)
    errors = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                  if _compressed(g, cfg) else None, grads)
    return PowerSGDState(q_tree, errors)


def _orth(p: torch.Tensor) -> torch.Tensor:
    """Local CholeskyQR: P is replicated after its all-reduce, so no comm."""
    p32 = p.float()
    g = p32.transpose(-1, -2) @ p32
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    g = g + 1e-12 * eye * torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    chol = torch.linalg.cholesky(g)
    return p32 @ torch.linalg.inv(chol).transpose(-1, -2)


def compress_allreduce(grads: Any, state: PowerSGDState, axis_name: Optional[str],
                       cfg: PowerSGDConfig = PowerSGDConfig()):
    """All-reduce ``grads`` over ``axis_name``, compressing large matrices.
    Returns (mean_grads, new_state); the factors are mean-reduced."""

    def one(g, q, e):
        if q is None:
            return pmean(g, axis_name), None, None
        g32 = g.float()
        if cfg.ef and e is not None:
            g32 = g32 + e
        # one warm-started power iteration: P = G Q; orth; Q' = G^T P
        p = _orth(pmean(g32 @ q, axis_name))
        q_new = pmean(g32.transpose(-1, -2) @ p, axis_name)
        approx = p @ q_new.transpose(-1, -2)
        err = (g32 - approx) if cfg.ef else None
        return approx.to(g.dtype), q_new, err

    outs = tree_map(one, grads, state.qs, state.errors)
    return tree_part(outs, 0), PowerSGDState(tree_part(outs, 1), tree_part(outs, 2))


def comm_bytes(grads: Any, cfg: PowerSGDConfig = PowerSGDConfig()) -> tuple[int, int]:
    """(dense bytes, compressed bytes) of one all-reduce of ``grads``."""
    dense = comp = 0
    for _, g in tree_paths(grads):
        b = g.numel() * g.element_size()
        dense += b
        if _compressed(g, cfg):
            c, d = g.shape[-2], g.shape[-1]
            lead = g.numel() // (c * d)
            r = min(cfg.rank, min(c, d))
            comp += lead * (c + d) * r * 4
        else:
            comp += b
    return dense, comp
