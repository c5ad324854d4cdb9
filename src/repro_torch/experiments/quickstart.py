"""Quickstart: RSI in a minute.

    python -m repro_torch.experiments.quickstart [--device cuda|cpu]

The twin of the reference's ``examples/quickstart.py``:
1. build a weight matrix with the slow-decay spectrum of a pretrained layer;
2. compress it with RSVD (q=1) and RSI (q=2, 4): the normalized error drops;
3. compress a whole (reduced llama) model's params with one call;
4. certify a compressed classifier head with the paper's Theorem 3.2.
Every draw comes from a ``torch.Generator`` seeded as the reference seeds
its keys.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CompressionPolicy,
    certify_head,
    compress_tree,
    normalized_error,
    rsi,
    rsi_factors,
    synth_spectrum_matrix,
    vgg_like_spectrum,
)
from repro_torch.models.model import build_model
from repro_torch.runtime.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # --- 1. a "pretrained-like" matrix ------------------------------------
    C, D, k = 512, 2048, 64
    spectrum = vgg_like_spectrum(C, device=dev)
    W = synth_spectrum_matrix(C, D, spectrum, generator=gen(0), device=dev)
    print(f"W: {C}x{D}, slow-decay spectrum (s1={float(spectrum[0]):.1f}, s_{k+1}={float(spectrum[k]):.3f})")

    # --- 2. RSVD vs RSI ---------------------------------------------------
    errors = {}
    for q in (1, 2, 4):
        res = rsi(W, k, q, generator=gen(1))
        errors[q] = float(normalized_error(W, res.U, res.S, res.Vt, float(spectrum[k]), gen(2)))
        label = "RSVD" if q == 1 else f"RSI q={q}"
        print(f"  {label:9s} normalized spectral error = {errors[q]:.3f}  (optimal = 1.0)")
    A, B = rsi_factors(W, k, 4, generator=gen(1))
    print(f"  factored: {W.numel():,} params -> {A.numel() + B.numel():,} "
          f"({(A.numel() + B.numel()) / W.numel():.1%})")

    # --- 3. whole-model compression ---------------------------------------
    model = build_model(get_arch("llama3.2-1b", reduced=True), device=dev)
    params = model.init(gen(3))
    _, report = compress_tree(params, CompressionPolicy(alpha=0.3, q=4, min_dim=32), generator=gen(4))
    print(f"model: {report.summary()}")

    # --- 4. Theorem 3.2 certificate ---------------------------------------
    head = synth_spectrum_matrix(10, 256, vgg_like_spectrum(10, device=dev) * 0.05, generator=gen(5), device=dev)
    A2, B2 = rsi_factors(head, 6, 4, generator=gen(6))
    calib = torch.randn((256, 256), generator=gen(7), device=dev)
    calib = calib / torch.linalg.vector_norm(calib, dim=-1, keepdim=True) * 3.0
    cert = certify_head(head, A2 @ B2, calib, gen(8), rank=6, q=4)
    print(f"certificate: ||W-W~||_2={cert.spectral_error:.4f}, R={cert.feature_radius:.2f} "
          f"=> max class-probability deviation <= {cert.prob_deviation_bound:.4f}")
    return {"errors": errors, "report": report, "certificate": cert}


if __name__ == "__main__":
    main()
