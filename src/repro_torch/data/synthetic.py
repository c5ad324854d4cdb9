"""Deterministic synthetic token streams (a copy of the reference's
``repro/data/synthetic.py`` for the LM case).

Batch contents are a pure function of (seed, step), so the port and the
reference build identical prompts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM", "markov_tokens"]


def markov_tokens(seed: int, step: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """Cheap structured (non-uniform) token stream: a hashed Markov-ish chain;
    pure function of (seed, step)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    steps = rng.integers(1, 7, size=(batch, seq), dtype=np.int64)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)


class SyntheticLM:
    """Iterator of LM batches ({"tokens"} and, for training, {"targets"})."""

    def __init__(self, cfg, batch: int, seq: int, *, kind: str = "train", seed: int = 0):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(f"modality inputs of family {cfg.family!r} are not yet ported")
        self.cfg, self.batch, self.seq, self.kind, self.seed = cfg, batch, seq, kind, seed
        self.step = 0

    def at_step(self, step: int) -> dict:
        toks = markov_tokens(self.seed, step, self.batch, self.seq + 1, self.cfg.vocab)
        out = {"tokens": toks[:, :-1]}
        if self.kind == "train":
            out["targets"] = toks[:, 1:]
        return out

    def __iter__(self):
        return self

    def __next__(self):
        b = self.at_step(self.step)
        self.step += 1
        return b
