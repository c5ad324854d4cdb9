"""Deterministic synthetic data (a copy of the reference's
``repro/data/synthetic.py``): token streams, the modality-frontend stubs
(a vlm's ``image_embed``, an audio model's ``frames``) and the Table 4.1
classifier.

Contents are a pure function of the seed (and step), drawn from the same
numpy generators in the same order as the reference's, so the port and the
reference build identical prompts, request payloads and datasets.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM", "markov_tokens", "modality_extras", "classification_dataset"]


def modality_extras(cfg, rng) -> dict:
    """Per-REQUEST (unbatched) modality-frontend stubs for serving: the extra
    model inputs one request of this arch family needs, drawn from ``rng``
    (a vlm's ``image_embed`` (n_image_tokens, d_model), an audio model's
    ``frames`` (n_audio_frames, d_model), fp32; nothing otherwise)."""
    e = {}
    if cfg.family == "vlm":
        e["image_embed"] = rng.standard_normal((cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        e["frames"] = rng.standard_normal((cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return e


def markov_tokens(seed: int, step: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    """Cheap structured (non-uniform) token stream: a hashed Markov-ish chain;
    pure function of (seed, step)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    steps = rng.integers(1, 7, size=(batch, seq), dtype=np.int64)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)


class SyntheticLM:
    """Iterator of LM batches: {"tokens"}, for training {"targets"}, and a
    vlm's {"image_embed"} (B, n_image_tokens, d_model) or an audio model's
    {"frames"} (B, n_audio_frames, d_model), fp32."""

    def __init__(self, cfg, batch: int, seq: int, *, kind: str = "train", seed: int = 0):
        self.cfg, self.batch, self.seq, self.kind, self.seed = cfg, batch, seq, kind, seed
        self.step = 0

    def at_step(self, step: int) -> dict:
        cfg = self.cfg
        toks = markov_tokens(self.seed, step, self.batch, self.seq + 1, cfg.vocab)
        out = {"tokens": toks[:, :-1]}
        if self.kind == "train":
            out["targets"] = toks[:, 1:]
        rng = np.random.default_rng(np.uint64(self.seed) * np.uint64(7919) + np.uint64(step))
        if cfg.family == "vlm":
            out["image_embed"] = rng.standard_normal((self.batch, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal((self.batch, cfg.n_audio_frames, cfg.d_model), dtype=np.float32)
        return out

    def __iter__(self):
        return self

    def __next__(self):
        b = self.at_step(self.step)
        self.step += 1
        return b


def classification_dataset(seed: int, n: int, dim: int, n_classes: int, *, margin: float = 1.5):
    """Synthetic 10-class dataset for the Table-4.1 reproduction: Gaussian
    clusters with controlled separation (margin) in `dim` dims.  Returns
    (X (n,dim) fp32, y (n,) int32, class_means)."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n_classes, dim)).astype(np.float32) * margin
    y = rng.integers(0, n_classes, size=(n,))
    X = means[y] + rng.standard_normal((n, dim)).astype(np.float32)
    return X.astype(np.float32), y.astype(np.int32), means
