"""Token sampling for the serving engine: greedy, temperature, top-k.

The port's counterpart of ``repro/serving/sampling.py``.  The reference
draws with threefry (``jax.random.fold_in`` + ``categorical``), which no
other framework reproduces, so the port defines its own rule:

* a request's stream is a pure function of (seed, token index): the salt is
  ``(seed * SALT_MULT + token_index) & 0x7FFFFFFF``, as in the reference, so
  a trace replays identically however requests were interleaved;
* each (salt, vocabulary id) pair is hashed with a counter-based 32-bit
  integer hash computed in int64 torch ops (every product stays below
  2**63, so nothing overflows) into a uniform ``u`` in (0, 1);
* the token is the Gumbel-max draw ``argmax(logits / T - log(-log(u)))``
  over the top-k filtered logits (top-k by rank: a stable sort breaks ties
  by vocabulary id).

Rows with temperature 0 take the exact argmax; ``top_k == 1`` leaves one
candidate and is greedy too.  The whole draw is fixed-shape tensor work with
no host sync, so the engine captures it in its CUDA-graph decode block.
Draws agree between the plain CPU path and the card up to the last bits of
``log``; the determinism contract is per device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingParams", "SALT_MULT", "token_salts", "sample_tokens"]

SALT_MULT = 1_000_003
_MASK32 = 0xFFFFFFFF


def token_salts(seeds: torch.Tensor, token_index: torch.Tensor) -> torch.Tensor:
    """Per-row salts: (B,) seeds (the low 32 bits of the request seed) x (B,)
    token indices -> (B,) int64 in [0, 2**31)."""
    return (seeds.long() * SALT_MULT + token_index.long()) & 0x7FFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for x in [0, 2**32), in int64 without overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(salts: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) salts -> (B, vocab) fp32 Gumbel noise, a pure function of
    (salt, vocabulary id)."""
    ids = torch.arange(vocab, device=salts.device, dtype=torch.int64)
    h = _fmix32(_fmix32(salts.long())[:, None] ^ _fmix32(ids + 0x632BE5AB)[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # 24 bits: exact in fp32, strictly inside (0, 1)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0.0 => greedy (exact argmax); > 0 => softmax sampling.
    top_k: 0 => full vocabulary; k > 0 => restrict to the k highest logits.
    seed: seed of this request's sample stream.
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def sample_tokens(logits: torch.Tensor, salts: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor) -> torch.Tensor:
    """One token per row with per-row sampling params.

    logits: (B, V) fp32; salts: (B,) int64 (:func:`token_salts`);
    temperature: (B,) fp32, rows with 0 take the argmax; top_k: (B,) int,
    rows with 0 sample the whole vocabulary.  Returns (B,) int64 ids.
    """
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    t = torch.where(temperature > 0, temperature, torch.ones_like(temperature)).float()
    scaled = logits.float() / t[:, None]
    order = torch.argsort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.empty_like(order).scatter_(1, order, torch.arange(V, device=logits.device).expand(B, V))
    k_eff = torch.where(top_k > 0, top_k.long(), torch.full_like(top_k.long(), V))
    masked = torch.where(ranks < k_eff[:, None], scaled, torch.full_like(scaled, float("-inf")))
    sampled = torch.argmax(masked + gumbel_noise(salts, V), dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
