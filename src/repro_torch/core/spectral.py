"""Spectral utilities: norm estimation, normalized error, synthetic spectra.

The port's counterpart of ``repro/core/spectral.py``.  The paper's quality
metric is the normalized spectral error ``||W - W_k~||_2 / s_{k+1}`` (== 1
for the optimal truncated SVD).  Randomness comes from an explicit
``torch.Generator`` wherever the reference takes a PRNG key.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

__all__ = [
    "spectral_norm",
    "normalized_error",
    "normalized_error_factored",
    "synth_spectrum_matrix",
    "vgg_like_spectrum",
    "spectralize_params",
    "effective_rank",
]


def spectral_norm(M: torch.Tensor, generator: Optional[torch.Generator] = None, *, iters: int = 32,
                  v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Randomized power-method estimate of ||M||_2 (fp32).

    The start vector is ``v0`` or a Gaussian drawn from ``generator``.  With
    ``iters`` power steps the estimate is a lower bound converging
    geometrically in (s2/s1)^iters.
    """
    m32 = M.float()
    if v0 is None:
        v0 = torch.randn((M.shape[1],), generator=generator, dtype=torch.float32, device=M.device)
    v = v0.to(device=M.device, dtype=torch.float32)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        u = m32 @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-30)
        w = m32.T @ u
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    return torch.linalg.vector_norm(m32 @ v)


def normalized_error(W, U, S, Vt, s_next, generator: Optional[torch.Generator] = None, *,
                     iters: int = 32, v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper metric: ||W - U S Vt||_2 / s_{k+1}, the product rounded to W's
    dtype before the subtraction, as the reference does."""
    approx = torch.matmul(U * S[None, :], Vt).to(W.dtype)
    return spectral_norm(W - approx, generator, iters=iters, v0=v0) / s_next


def normalized_error_factored(W, A, B, s_next, generator: Optional[torch.Generator] = None, *,
                              iters: int = 32, v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper metric for the factored form W ~= A @ B: ||W - A B||_2 / s_{k+1}."""
    approx = torch.matmul(A.float(), B.float()).to(W.dtype)
    return spectral_norm(W - approx, generator, iters=iters, v0=v0) / s_next


def vgg_like_spectrum(r: int, *, s1: float = 30.0, knee: float = 0.02, tail_decay: float = 0.35,
                      device=None) -> torch.Tensor:
    """Spectrum shaped like the paper's Fig 1.1(a): a fast initial drop then a
    slow tail (constants as in the reference)."""
    i = torch.arange(1, r + 1, dtype=torch.float32, device=device)
    fast = i ** (-1.2)
    slow = knee * (i / r) ** (-tail_decay)
    return s1 * (fast + slow) / (1.0 + knee)


def synth_spectrum_matrix(C: int, D: int, singular_values: torch.Tensor, *,
                          generator: Optional[torch.Generator] = None, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """Random (C, D) matrix with a prescribed singular spectrum: W = U diag(s) V^T
    with Haar factors (QR of Gaussians drawn from ``generator``)."""
    r = min(C, D)
    s = torch.as_tensor(singular_values, dtype=torch.float32, device=device)
    if tuple(s.shape) != (r,):
        raise ValueError(f"spectrum shape {tuple(s.shape)} != ({r},)")
    gu = torch.randn((C, r), generator=generator, dtype=torch.float32, device=device)
    gv = torch.randn((D, r), generator=generator, dtype=torch.float32, device=device)
    qu, _ = torch.linalg.qr(gu)
    qv, _ = torch.linalg.qr(gv)
    return ((qu * s[None, :]) @ qv.T).to(dtype)


def spectralize_params(params: Any, generator: torch.Generator, *, min_dim: int = 32,
                       spectrum=vgg_like_spectrum) -> Any:
    """Replace every large >=2-D kernel in a params tree with a matrix of the
    same shape and Frobenius norm but a PRETRAINED-LIKE slow-decay spectrum
    (each slice of a stacked (L, c, d) leaf gets its own).

    Freshly initialized Gaussian weights have near-flat spectra — the worst
    case for low-rank compression and not the regime the paper addresses.
    Leaves are visited in sorted-key order, as the reference flattens them.
    """

    def make(ref: torch.Tensor) -> torch.Tensor:
        c, d = ref.shape
        W = synth_spectrum_matrix(c, d, spectrum(min(c, d), device=ref.device), generator=generator,
                                  device=ref.device)
        scale = torch.linalg.vector_norm(ref.float()) / (torch.linalg.vector_norm(W) + 1e-9)
        return (W * scale).to(ref.dtype)

    def one(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dim() < 2 or min(leaf.shape[-2], leaf.shape[-1]) < min_dim:
            return leaf
        flat = leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
        return torch.stack([make(w) for w in flat]).reshape(leaf.shape)

    def walk(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: walk(node[k]) for k in sorted(node)}
        return one(node)

    return walk(params)


def effective_rank(s: torch.Tensor) -> torch.Tensor:
    """Entropy-based effective rank of a spectrum (for rank-policy heuristics)."""
    p = s / torch.sum(s)
    p = torch.where(p > 0, p, torch.ones_like(p))
    return torch.exp(-torch.sum(torch.where(s > 0, p * torch.log(p), torch.zeros_like(p))))
