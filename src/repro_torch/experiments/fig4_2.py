"""Figure 4.2: a ViT-B/32 encoder FFN layer (768 x 3072), full size, RSI vs
the exact SVD: normalized error and time.

    python -m repro_torch.experiments.fig4_2 [--trials 3] [--device cuda|cpu]

The twin of the reference's ``benchmarks/fig4_2.py``.  The ViT layer's
spectrum decays more slowly than VGG's; :func:`vit_like_spectrum` is the
reference's.  The exact-SVD baseline is ``torch.linalg.svd`` on the same
device (the yardstick, not a kernel of the port): one untimed warm-up call,
then one timed call, as every RSI cell gets one warm-up call before its
timed trials.  ``svd_speedup`` is the SVD's seconds over RSI's.

Randomness hooks as in :mod:`repro_torch.experiments.fig4_1`; the defaults
are the reference's seeds: W from 1, the trials' Omegas from 200 + t, the
warm-up's from 0, the error's start vector from 8.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import synth_spectrum_matrix
from repro_torch.experiments.fig4_1 import rsi_grid, wait
from repro_torch.runtime.device import resolve_device

__all__ = ["vit_like_spectrum", "run", "emit_csv"]


def vit_like_spectrum(r: int, device=None) -> torch.Tensor:
    """Flatter tail than VGG: fast drop over ~10 directions then near-plateau."""
    i = torch.arange(1, r + 1, dtype=torch.float32, device=device)
    return 20.0 * (i ** (-0.9) + 0.15 * (i / r) ** (-0.15)) / 1.15


def run(trials: int = 3, ks=(100, 300, 500), qs=(1, 2, 3, 4), *, shape=(768, 3072), device=None,
        W: Optional[torch.Tensor] = None,
        omega_fn: Optional[Callable[[int, int, Optional[int]], torch.Tensor]] = None,
        v0: Optional[torch.Tensor] = None) -> dict:
    dev = resolve_device(device)
    C, D = shape
    s = vit_like_spectrum(C, device=dev)
    if W is None:
        W = synth_spectrum_matrix(C, D, s, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    W = W.to(dev)
    if v0 is None:
        v0 = torch.randn((D,), generator=torch.Generator(device=dev).manual_seed(8), device=dev)

    # exact SVD baseline (one timing; the decomposition serves all k)
    torch.linalg.svd(W, full_matrices=True)  # warm
    wait(dev)
    t0 = time.perf_counter()
    torch.linalg.svd(W, full_matrices=True)
    wait(dev)
    svd_seconds = time.perf_counter() - t0

    rows = [dict(k=k, q=q, normalized_error=float(np.mean(errs)), seconds=float(np.mean(times)),
                 svd_speedup=svd_seconds / float(np.mean(times)))
            for k, q, errs, times in rsi_grid(W, s, ks, qs, trials, 200, omega_fn, v0)]
    return dict(C=C, D=D, svd_seconds=svd_seconds, rows=rows)


def emit_csv(result):
    print(f"fig4_2/exact_svd,{result['svd_seconds']*1e6:.0f},baseline=1.0")
    for r in result["rows"]:
        print(f"fig4_2/k={r['k']}/q={r['q']},{r['seconds']*1e6:.0f},"
              f"normalized_error={r['normalized_error']:.4f};svd_speedup={r['svd_speedup']:.1f}x")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(trials=args.trials, device=args.device)
    emit_csv(result)
    return result


if __name__ == "__main__":
    main()
