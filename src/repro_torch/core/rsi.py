"""Randomized Subspace Iteration (RSI) — the paper's Algorithm 3.1.

The port's counterpart of ``repro/core/rsi.py``: randomized low-rank
approximation with ``q`` power iterations (s_i -> s_i^{2q-1}); q = 1 is
plain randomized SVD.  The two products with W of every iteration,
``W @ Y`` and ``W^T @ X``, go through the sketch GEMM kernel (the latter
reads W transposed in place, never materializing W^T).  Orthonormalization
is CholeskyQR2; Cholesky, the triangular solve and ``eigh`` stay
``torch.linalg``.

Randomness: the Gaussian test matrix Omega is passed in (``omega=``) or
drawn from an explicit ``torch.Generator`` (``generator=``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels._build import aligned_rows
from repro_torch.runtime import dispatch

__all__ = [
    "RSIResult",
    "rsi",
    "rsvd",
    "rsi_factors",
    "cholesky_qr",
    "cholesky_qr2",
    "rsi_flops",
    "matmul_count",
    "QR_FALLBACKS",
]


class _FallbackCount:
    """Sketches that CholeskyQR2 could not orthonormalize (its Gram not
    positive definite in fp32) and Householder QR did, since import or the
    last :meth:`reset`."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


QR_FALLBACKS = _FallbackCount()


class RSIResult(NamedTuple):
    """Approximate truncated SVD ``W ~= U @ diag(S) @ Vt`` of rank ``k``."""

    U: torch.Tensor  # (C, k)
    S: torch.Tensor  # (k,)
    Vt: torch.Tensor  # (k, D)


def cholesky_qr(X: torch.Tensor, *, eps: float = 0.0) -> torch.Tensor:
    """One round of Cholesky QR: Q = X @ R^-1 with R = chol(X^T X), the Gram
    matrix accumulated in fp32 whatever X's dtype."""
    x32 = X.float()
    g = x32.T @ x32
    if eps:
        n = g.shape[0]
        g = g + eps * torch.trace(g) / n * torch.eye(n, dtype=g.dtype, device=g.device)
    L = torch.linalg.cholesky(g.T)  # lower, G = L L^T = R^T R with R = L^T
    q = torch.linalg.solve_triangular(L, x32.T, upper=False).T
    return q.to(X.dtype)


def cholesky_qr2(X: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2: two rounds restore orthogonality to ~machine precision."""
    return cholesky_qr(cholesky_qr(X, eps=1e-12))


def _orthonormalize(X: torch.Tensor, method: str) -> torch.Tensor:
    if method == "cholesky_qr2":
        try:
            return cholesky_qr2(X)
        except torch.linalg.LinAlgError:
            # From the second iteration on cond(X) ~ (s_1 / s_k)^2, and past
            # ~1/sqrt(eps) the fp32 Gram loses positive definiteness
            # (qwen2-72b's 8192-wide layers at k = 2458 on spectralized
            # weights).  The reference's CholeskyQR returns NaN factors there;
            # the port orthonormalizes the same X by Householder QR instead,
            # and counts it in QR_FALLBACKS.
            QR_FALLBACKS.count += 1
            return _orthonormalize(X, "householder")
    if method == "householder":
        q, _ = torch.linalg.qr(X.float())
        return q.to(X.dtype)
    raise ValueError(f"unknown qr_method {method!r}")


def rsi(
    W: torch.Tensor,
    k: int,
    q: int,
    *,
    omega: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    oversample: int = 0,
    qr_method: str = "cholesky_qr2",
    stabilize_every: int = 1,
) -> RSIResult:
    """Algorithm 3.1: randomized subspace iteration.

    Args:
      W: (C, D) weight matrix.
      k: target rank.
      q: number of power iterations; ``q=1`` is exactly RSVD.
      omega: the (D, k + oversample) Gaussian test matrix (any float dtype;
        cast to W's dtype as the reference does), or
      generator: a ``torch.Generator`` on W's device to draw it from.
      oversample, qr_method, stabilize_every: as in the reference.

    Returns:
      RSIResult(U (C,k), S (k,), Vt (k,D)) with W ~= U @ diag(S) @ Vt.
    """
    if q < 1:
        raise ValueError("q must be >= 1 (q=1 is RSVD)")
    C, D = W.shape
    ell = min(k + oversample, min(C, D))
    if omega is None:
        if generator is None:
            raise ValueError("rsi needs omega= or generator=")
        omega = torch.randn((D, ell), generator=generator, dtype=torch.float32, device=W.device)
    if tuple(omega.shape) != (D, ell):
        raise ValueError(f"omega shape {tuple(omega.shape)} != ({D}, {ell})")

    # --- Alg 3.1 lines 1-6: power iterations -------------------------------
    Y = aligned_rows(omega.to(device=W.device, dtype=W.dtype))  # (D, ell)
    X = None
    for t in range(q):
        X = dispatch.sketch_matmul(W, Y)  # (C, ell)
        if (t % max(stabilize_every, 1)) == 0 or t == q - 1:
            X = aligned_rows(_orthonormalize(X, qr_method))
        Y = dispatch.sketch_matmul(W, X, trans_a=True)  # (D, ell) = W^T X

    # --- Alg 3.1 lines 7-8: SVD of the small matrix Y^T via the Gram trick --
    y32 = Y.float()
    G = y32.T @ y32  # (ell, ell)
    evals, u_hat = torch.linalg.eigh(G)  # ascending
    evals = torch.clamp(evals, min=0.0)
    order = torch.argsort(-evals, stable=True)
    evals = evals[order]
    u_hat = u_hat[:, order]
    S = torch.sqrt(evals)
    s_safe = torch.where(S > 0, S, torch.ones_like(S))
    V = y32 @ (u_hat / s_safe[None, :])  # (D, ell)
    U = (X.float() @ u_hat).to(W.dtype)  # (C, ell)
    return RSIResult(U=U[:, :k].to(W.dtype), S=S[:k].to(W.dtype), Vt=V[:, :k].T.to(W.dtype))


def rsvd(W: torch.Tensor, k: int, **kw) -> RSIResult:
    """Randomized SVD (Halko et al.) == RSI with q = 1."""
    return rsi(W, k, 1, **kw)


def rsi_factors(W: torch.Tensor, k: int, q: int, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper Sec. 3 factored form: W ~= A @ B, A = U S^1/2 (C,k), B = S^1/2 V^T (k,D)."""
    res = rsi(W, k, q, **kw)
    root_s = torch.sqrt(torch.clamp(res.S.float(), min=0.0)).to(W.dtype)
    return res.U * root_s[None, :], root_s[:, None] * res.Vt


def matmul_count(q: int) -> int:
    """m of Eq. (3.14): number of multiplications with W or W^T."""
    return 2 * q


def rsi_flops(C: int, D: int, k: int, q: int, *, oversample: int = 0) -> int:
    """Dominant FLOP count of Alg 3.1 (same formula as the reference).

    Per iteration: W@Y (2CDl) + CholeskyQR2 on (C,l) (~ 2*(2Cl^2)) + W^T@X (2CDl);
    epilogue: Gram (2Dl^2) + eigh (~26 l^3, lumped) + V (2Dl^2) + U (2Cl^2).
    """
    ell = k + oversample
    per_iter = 2 * C * D * ell * 2 + 4 * C * ell * ell
    epilogue = 4 * D * ell * ell + 2 * C * ell * ell + 26 * ell**3
    return q * per_iter + epilogue
