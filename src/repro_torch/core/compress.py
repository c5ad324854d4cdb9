"""Layer-wise RSI compression over model parameter trees.

The port's counterpart of ``repro/core/compress.py`` (the paper's Sec. 4.2
as a framework component): walk a params tree, select compressible linear
kernels by policy, run RSI on each, and emit (i) a new tree where selected
dense leaves are replaced by factored ``{"a","b"}`` subtrees and (ii) a
:class:`CompressionReport`.

Stacked ``(L, d_in, d_out)`` leaves get one independent sketch per layer;
the reference's ``vmap`` over layers is a loop here.  The rank rule is the
paper's ``k = ceil(alpha * min(C, D))`` (``rank_rule="alpha"``) or the
reference's adaptive ``energy`` rule: the smallest k whose singular values
hold ``energy`` of the squared mass of one probe sketch.  Sharding specs are
not ported (the port has no mesh yet).

Randomness: Omega for every (leaf, layer) is drawn from ``generator`` in
sorted-key leaf order, or supplied by ``omega_fn(path, layer, shape)`` —
the parity tests use the latter to hand the port the reference's Omegas.
The energy rule's probe asks for ``omega_fn(path, None, (D, ell_probe))``:
the reference draws it from the leaf's own (unsplit) key.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core import lowrank
from repro_torch.core.rsi import rsi, rsi_factors

__all__ = ["CompressionPolicy", "LayerReport", "CompressionReport", "compress_tree"]


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """What to compress and how hard (fields as in the reference).

    alpha: rank k = ceil(alpha * min dim); q: RSI iterations (1 == RSVD);
    rank_rule: 'alpha' (k from alpha) or 'energy' (the smallest k holding
    ``energy`` of the squared singular mass); min_dim: skip smaller matrices;
    include / exclude: regexes on the '/'-joined param path (exclude also
    catches stacked norm scales, see below);
    break_even_only: skip layers whose rank would not shrink them;
    oversample: RSI oversampling p; max_rank: optional cap on k.
    """

    alpha: float = 0.4
    q: int = 4
    rank_rule: str = "alpha"
    energy: float = 0.95
    min_dim: int = 257
    include: str = r".*"
    # the reference's pattern plus any segment ENDING in "norm": the stacked
    # (L, d) norm scales (layers/attn_norm/scale) are vectors, not matrices,
    # and at min_dim <= L the reference compresses their all-ones rank-1 stack
    # (CholeskyQR's Gram is then singular: NaN there, an error here)
    exclude: str = r"(?:^|/)(embed|embedding|router|gate_w|conv|dt_|A_log|D_param|norm)|norm(?:/|$)"
    break_even_only: bool = True
    oversample: int = 0
    max_rank: Optional[int] = None

    def rank_for(self, c: int, d: int) -> int:
        k = int(-(-self.alpha * min(c, d) // 1))  # ceil
        if self.max_rank is not None:
            k = min(k, self.max_rank)
        return max(k, 1)


@dataclasses.dataclass
class LayerReport:
    path: str
    shape: tuple
    rank: int
    params_before: int
    params_after: int
    compressed: bool
    reason: str = ""


@dataclasses.dataclass
class CompressionReport:
    policy: CompressionPolicy
    layers: list
    params_before: int = 0
    params_after: int = 0

    @property
    def ratio(self) -> float:
        """Paper's compression ratio: compressed params / original params."""
        return self.params_after / max(self.params_before, 1)

    def summary(self) -> str:
        n = sum(1 for l in self.layers if l.compressed)
        return (
            f"compressed {n}/{len(self.layers)} tensors, "
            f"ratio={self.ratio:.3f} (alpha={self.policy.alpha}, q={self.policy.q})"
        )


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) in the reference's flatten order (sorted dict keys)."""
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(node, Mapping):
            yield from _leaves(node, name)
        else:
            yield name, node


def _set(tree: dict, path: str, value: Any) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def _copy_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _energy_rank(W2d: torch.Tensor, probe: int, policy: CompressionPolicy, omega: torch.Tensor) -> int:
    """Adaptive rank: sketch the spectrum once at the ``probe`` (break-even)
    rank with RSI at ``max(q, 2)``, then take the smallest k holding
    ``energy`` of the squared mass (``searchsorted`` on the left, as the
    reference), clamped to ``[1, probe]``.

    Where the sketch is numerically rank-deficient (a spectrum far sharper
    than the probe rank), CholeskyQR's Gram is not positive definite in
    fp32: the reference's probe then returns NaN singular values and its
    ``searchsorted`` lands on rank 1; the port redoes the probe from the same
    Omega with Householder QR and reads the rank off real singular values."""
    q = max(policy.q, 2)
    try:
        res = rsi(W2d, probe, q, omega=omega, oversample=policy.oversample)
    except torch.linalg.LinAlgError:
        res = rsi(W2d, probe, q, omega=omega, oversample=policy.oversample, qr_method="householder")
    s2 = torch.cumsum(res.S.float() ** 2, dim=0)
    k = int(torch.searchsorted(s2, (policy.energy * s2[-1]).reshape(1))[0]) + 1
    return max(1, min(k, probe))


def compress_tree(
    params: Any,
    policy: CompressionPolicy,
    *,
    generator: Optional[torch.Generator] = None,
    omega_fn: Optional[Callable[[str, Optional[int], tuple], torch.Tensor]] = None,
) -> tuple[Any, CompressionReport]:
    """Compress every policy-selected kernel in ``params``.

    ``omega_fn(path, layer, (D, ell))`` returns Omega for one matrix
    (``layer`` is None for a 2-D leaf); otherwise Omega is drawn from
    ``generator``.  Returns ``(new_params, report)``; leaves not compressed
    are shared with ``params``.
    """
    if policy.rank_rule not in ("alpha", "energy"):
        raise ValueError(f"rank_rule {policy.rank_rule!r}: 'alpha' or 'energy'")
    if generator is None and omega_fn is None:
        raise ValueError("compress_tree needs generator= or omega_fn=")
    inc, exc = re.compile(policy.include), re.compile(policy.exclude)
    report = CompressionReport(policy=policy, layers=[])
    new_params = _copy_tree(params)

    for name, leaf in list(_leaves(params)):
        report.params_before += leaf.numel()
        report.params_after += leaf.numel()  # adjusted below on compression
        if leaf.dim() < 2:
            continue
        c, d = leaf.shape[-2], leaf.shape[-1]
        entry = LayerReport(path=name, shape=tuple(leaf.shape), rank=0, params_before=leaf.numel(),
                            params_after=leaf.numel(), compressed=False)
        report.layers.append(entry)
        if not inc.search(name) or exc.search(name):
            entry.reason = "policy-excluded"
            continue
        if min(c, d) < policy.min_dim:
            entry.reason = f"min-dim {min(c, d)} < {policy.min_dim}"
            continue
        if policy.rank_rule == "energy":
            probe = min(lowrank.break_even_rank(c, d), min(c, d))
            shape = (d, min(probe + policy.oversample, min(c, d)))
            omega = (omega_fn(name, None, shape) if omega_fn is not None else
                     torch.randn(shape, generator=generator, dtype=torch.float32, device=leaf.device))
            rank = _energy_rank(leaf.reshape((-1, c, d))[0], probe, policy, omega)
        else:
            rank = policy.rank_for(c, d)
        if policy.break_even_only and rank >= lowrank.break_even_rank(c, d):
            entry.reason = f"rank {rank} >= break-even {lowrank.break_even_rank(c, d)}"
            continue

        ell = min(rank + policy.oversample, min(c, d))

        def fact(W: torch.Tensor, layer: Optional[int]):
            omega = omega_fn(name, layer, (d, ell)) if omega_fn is not None else None
            return rsi_factors(W, rank, policy.q, omega=omega, generator=generator,
                               oversample=policy.oversample)

        lead = tuple(leaf.shape[:-2])
        if lead:
            flat = leaf.reshape((-1, c, d))
            pairs = [fact(flat[i], i) for i in range(flat.shape[0])]
            A = torch.stack([a for a, _ in pairs]).reshape(lead + (c, rank))
            B = torch.stack([b for _, b in pairs]).reshape(lead + (rank, d))
        else:
            A, B = fact(leaf, None)

        _set(new_params, name, lowrank.lowrank_params(A, B))
        entry.rank = rank
        entry.params_after = A.numel() + B.numel()
        entry.compressed = True
        report.params_after += entry.params_after - entry.params_before

    return new_params, report
