"""Theorem 3.2 machinery: softmax-perturbation certificates for compression.

The port's counterpart of ``repro/core/bounds.py``.  For logits
z = W h(x) + b and z~ = W~ h(x) + b,

    || softmax(z~) - softmax(z) ||_inf  <=  (1/2) * R * ||W - W~||_2,

with R >= sup_x ||h(x)||_2.  This module holds the Jacobian (Lemma 3.1),
the bound, and the certificate of one compressed classifier head (or of one
nested rank tier of a factor pair).

Randomness: the power method's start vector is ``v0`` or is drawn from
``generator``, as :func:`repro_torch.core.spectral.spectral_norm` takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.spectral import spectral_norm

__all__ = [
    "softmax_jacobian",
    "softmax_perturbation_bound",
    "CompressionCertificate",
    "certify_head",
    "certify_tier",
]


def softmax_jacobian(u: torch.Tensor) -> torch.Tensor:
    """Lemma 3.1: J_sigma(u) = diag(sigma(u)) - sigma(u) sigma(u)^T."""
    s = torch.softmax(u, dim=-1)
    return torch.diag(s) - torch.outer(s, s)


def softmax_perturbation_bound(spectral_err, R):
    """Theorem 3.2 RHS: (1/2) R ||W - W~||_2."""
    return 0.5 * R * spectral_err


@dataclasses.dataclass(frozen=True)
class CompressionCertificate:
    """Reliability certificate for one compressed classifier head.

    Attributes:
      spectral_error: estimated ||W - W~||_2.
      feature_radius: R, max ||h(x)||_2 over the calibration set (plus slack).
      prob_deviation_bound: (1/2) R ||W - W~||_2, Thm 3.2's guarantee on every
        class probability for every input with ||h|| <= R.
      rank: rank of the approximation.
      q: RSI iteration count used.
    """

    spectral_error: float
    feature_radius: float
    prob_deviation_bound: float
    rank: int
    q: int

    def guarantees_top1_stability(self, margin: float) -> bool:
        """If the calibration top-1 softmax margin exceeds 2x the bound, the
        argmax prediction provably cannot flip for those inputs."""
        return margin > 2.0 * self.prob_deviation_bound


def certify_head(W: torch.Tensor, W_approx: torch.Tensor, calib_features: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, rank: int, q: int, radius_slack: float = 1.0,
                 v0: Optional[torch.Tensor] = None) -> CompressionCertificate:
    """Build a Thm-3.2 certificate from a calibration feature batch (N, D)."""
    err = float(spectral_norm(W - W_approx, generator, v0=v0))
    R = float(torch.max(torch.linalg.vector_norm(calib_features.float(), dim=-1)))
    R *= radius_slack
    return CompressionCertificate(spectral_error=err, feature_radius=R,
                                  prob_deviation_bound=float(softmax_perturbation_bound(err, R)), rank=rank, q=q)


def certify_tier(a: torch.Tensor, b: torch.Tensor, tier_rank: int, generator: Optional[torch.Generator] = None, *,
                 q: int, feature_radius: Optional[float] = None,
                 v0: Optional[torch.Tensor] = None) -> CompressionCertificate:
    """Thm-3.2 certificate for a nested tier of one factor pair.

    The tier-``r'`` head is the prefix slice of the stored rank-``r`` factors,
    so the extra deviation it introduces over the serving tier is the
    spectral norm of the dropped tail ``A[:, r':] @ B[r':, :]``: the largest
    dropped singular value, as RSI orders directions by decreasing singular
    value.  Stacked factors certify their worst slice, every slice from the
    same start vector (the reference reuses its key).  ``feature_radius``
    defaults to 1.0.
    """
    if tier_rank >= a.shape[-1]:
        err = 0.0
    else:
        tail = a.float()[..., :, tier_rank:] @ b.float()[..., tier_rank:, :]
        if v0 is None:
            v0 = torch.randn((tail.shape[-1],), generator=generator, dtype=torch.float32, device=tail.device)
        if tail.dim() > 2:
            flat = tail.reshape((-1,) + tuple(tail.shape[-2:]))
            err = max(float(spectral_norm(flat[i], v0=v0)) for i in range(flat.shape[0]))
        else:
            err = float(spectral_norm(tail, v0=v0))
    R = 1.0 if feature_radius is None else float(feature_radius)
    return CompressionCertificate(spectral_error=err, feature_radius=R,
                                  prob_deviation_bound=float(softmax_perturbation_bound(err, R)),
                                  rank=int(tier_rank), q=q)
