"""Mesh-distributed RSI: the port's counterpart of ``repro/core/distributed_rsi.py``.

Compresses a weight matrix that is already sharded over a (data, model)
mesh -- qwen2-72b's 8192 x 29568 FFN kernels held FSDP x TP, never gathered
to one rank.  Each rank runs the block body on its local blocks:

    W    : (row_axis, col_axis)   block (C/dp, D/tp)
    Omega: (col_axis, None)       block (D/tp, l)
    X    : (row_axis, None)       block (C/dp, l)
    Y    : (col_axis, None)       block (D/tp, l)

Communication a power iteration: the psum over col_axis of the partial X
((C/dp) l words), the psum over row_axis of the partial Y ((D/tp) l words)
and the two psums of the l x l Gram matrices of CholeskyQR2.  No tall
matrix is ever gathered; the only replicated objects are l x l.  The
epilogue SVD uses the Gram trick (G = Y^T Y psum'd, ``eigh``), so the
factors come back as local blocks: U on (row_axis, None), Vt on
(None, col_axis).

Products are fp32, as the reference's (``preferred_element_type=f32`` on
the fp32-cast block); the two with W run through ``runtime/dispatch.py::
sketch_matmul``, the port's sketch GEMM kernel on the card.

Where CholeskyQR2's Gram loses positive definiteness in fp32, the
reference's factors are NaN; the port's single-device RSI redoes X by
Householder QR (``core/rsi.py::_orthonormalize``).  Here the same redo runs
without gathering the tall X, by TSQR: a Householder QR of each row block,
the l x l R factors gathered over row_axis (through the host on gloo), a QR
of their stack, and each block of X rebuilt from its Q and its slice of the
stack's Q.  Each redo counts in ``rsi.QR_FALLBACKS``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.core.rsi import QR_FALLBACKS, RSIResult
from repro_torch.kernels._build import aligned_rows
from repro_torch.runtime import dispatch
from repro_torch.runtime.distributed import Mesh, all_gather, axis_index, axis_names, axis_size, psum

__all__ = ["distributed_rsi", "distributed_rsi_factors", "dist_orthonormalize"]

Axis = Union[str, Sequence[str], None]


def _dist_cholesky_qr(X: torch.Tensor, row_axis: Axis, mesh: Optional[Mesh], *, eps: float = 0.0) -> torch.Tensor:
    """CholeskyQR with the Gram matrix psum'd over the row shards."""
    x32 = X.float()
    g = psum(x32.T @ x32, row_axis, mesh)
    if eps:
        n = g.shape[0]
        g = g + eps * torch.trace(g) / n * torch.eye(n, dtype=g.dtype, device=g.device)
    L = torch.linalg.cholesky(g.T)  # G = L L^T = R^T R with R = L^T
    q = torch.linalg.solve_triangular(L, x32.T, upper=False).T
    return q.to(X.dtype)


def _tsqr(X: torch.Tensor, row_axis: Axis, mesh: Optional[Mesh]) -> torch.Tensor:
    """Orthonormal basis of the row-sharded X (Householder QR, no tall gather)."""
    q_loc, r_loc = torch.linalg.qr(X.float())  # (c, m), (m, l) with m = min(c, l)
    stack = r_loc[None]
    for a in reversed(axis_names(row_axis)):  # the flattened row index puts the first name major
        stack = all_gather(stack, a, mesh).flatten(0, 1)
    q2, _ = torch.linalg.qr(stack.flatten(0, 1))  # (n m, l)
    m = r_loc.shape[0]
    i = axis_index(row_axis, mesh)
    return (q_loc @ q2[i * m:(i + 1) * m]).to(X.dtype)


def dist_orthonormalize(X: torch.Tensor, row_axis: Axis, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """CholeskyQR2 over the row shards; TSQR where its fp32 Gram is not
    positive definite (counted in ``QR_FALLBACKS``).  Every member of the
    row group holds the same Gram bits, so all take the same branch."""
    try:
        return _dist_cholesky_qr(_dist_cholesky_qr(X, row_axis, mesh, eps=1e-12), row_axis, mesh)
    except torch.linalg.LinAlgError:
        QR_FALLBACKS.count += 1
        return _tsqr(X, row_axis, mesh)


def distributed_rsi(
    W: torch.Tensor,
    k: int,
    q: int,
    *,
    omega: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    row_axis: Axis = "data",
    col_axis: Axis = "model",
    oversample: int = 0,
    mesh: Optional[Mesh] = None,
) -> RSIResult:
    """Distributed Algorithm 3.1 on this rank's block W (C/dp, D/tp) of a
    (C, D) matrix sharded (row_axis, col_axis).

    ``omega``: the whole (D, l) Gaussian test matrix (every rank takes its
    rows; cast to W's dtype as the reference casts it), or ``generator``: a
    ``torch.Generator`` on W's device to draw it from, seeded alike on
    every rank.  Returns this rank's blocks: U (C/dp, k), S (k,) replicated,
    Vt (k, D/tp).
    """
    if q < 1:
        raise ValueError("q must be >= 1 (q=1 is RSVD)")
    c, d = W.shape
    C, D = c * axis_size(row_axis, mesh), d * axis_size(col_axis, mesh)
    ell = min(k + oversample, min(C, D))
    if omega is None:
        if generator is None:
            raise ValueError("distributed_rsi needs omega= or generator=")
        omega = torch.randn((D, ell), generator=generator, dtype=torch.float32, device=W.device)
    if tuple(omega.shape) != (D, ell):
        raise ValueError(f"omega shape {tuple(omega.shape)} != ({D}, {ell})")
    j = axis_index(col_axis, mesh)
    # the GEMM operands in aligned rows, as core/rsi.py keeps them
    Y = aligned_rows(omega[j * d:(j + 1) * d].to(device=W.device, dtype=W.dtype).float())
    W32 = aligned_rows(W.float())
    X = None
    for _ in range(q):
        X = psum(dispatch.sketch_matmul(W32, Y), col_axis, mesh)  # (c, l) summed over the D shards
        X = aligned_rows(dist_orthonormalize(X, row_axis, mesh))
        Y = aligned_rows(psum(dispatch.sketch_matmul(W32, X, trans_a=True), row_axis, mesh))  # (d, l) over C

    G = psum(Y.T @ Y, col_axis, mesh)  # (l, l), replicated
    evals, u_hat = torch.linalg.eigh(G)  # ascending
    evals = torch.clamp(evals, min=0.0)
    order = torch.argsort(-evals, stable=True)
    evals, u_hat = evals[order], u_hat[:, order]
    S = torch.sqrt(evals)
    s_safe = torch.where(S > 0, S, torch.ones_like(S))
    V = Y @ (u_hat / s_safe[None, :])  # (d, l), sharded on D
    U = X @ u_hat  # (c, l), sharded on C
    return RSIResult(U=U[:, :k].to(W.dtype), S=S[:k].to(W.dtype), Vt=V[:, :k].T.to(W.dtype))


def distributed_rsi_factors(W: torch.Tensor, k: int, q: int, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's blocks of the factored form: A (C/dp, k) on (row, None),
    B (k, D/tp) on (None, col)."""
    res = distributed_rsi(W, k, q, **kw)
    root_s = torch.sqrt(torch.clamp(res.S.float(), min=0.0)).to(W.dtype)
    return res.U * root_s[None, :], root_s[:, None] * res.Vt
