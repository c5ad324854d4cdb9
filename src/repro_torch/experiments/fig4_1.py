"""Figure 4.1: normalized spectral error and runtime of RSI vs (k, q) on a
VGG19-classifier-sized layer.

    python -m repro_torch.experiments.fig4_1 [--full] [--trials 3] [--device cuda|cpu]

The twin of the reference's ``benchmarks/fig4_1.py``.  The layer is
4096 x 25088 (``full=True``, the paper's VGG19-FC1 shape, fp32) or a
1/4-scale 1024 x 6272 matrix with the same spectrum shape; it is built with
the slow-decay spectrum of Fig 1.1 (``synth_spectrum_matrix``), so
s_{k+1} is known exactly.  Each (k, q) cell runs one untimed warm-up call
(which also builds the kernels at first use), then ``trials`` timed RSI
calls, each waited on (``torch.cuda.synchronize``); the time includes
drawing Omega, as the reference's jitted call does.

Randomness hooks: ``W`` (the test matrix), ``omega_fn(k, q, trial)`` (Omega
of one call, (D, k); ``trial`` is None for the warm-up) and ``v0`` (the
error's power-method start vector).  Otherwise W comes from seed 0, the
trials' Omegas from seeds 100 + t, the warm-up's from seed 0 and v0 from
seed 7, each a ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import normalized_error, rsi, rsi_flops, synth_spectrum_matrix, vgg_like_spectrum
from repro_torch.runtime.device import resolve_device

__all__ = ["run", "emit_csv", "rsi_grid", "timed_rsi", "wait"]


def wait(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_rsi(W: torch.Tensor, k: int, q: int, omega: Optional[torch.Tensor], seed: int):
    """One RSI call and its seconds, waited on.  Omega is ``omega`` or drawn
    inside the timed call from a generator seeded ``seed``."""
    dev = W.device
    wait(dev)
    t0 = time.perf_counter()
    gen = None if omega is not None else torch.Generator(device=dev).manual_seed(seed)
    res = rsi(W, k, q, omega=omega, generator=gen)
    wait(dev)
    return res, time.perf_counter() - t0


def rsi_grid(W: torch.Tensor, s: torch.Tensor, ks, qs, trials: int, trial_seed: int,
             omega_fn: Optional[Callable[[int, int, Optional[int]], torch.Tensor]], v0: torch.Tensor):
    """Yield ``(k, q, errors, seconds)`` of each cell: one untimed warm-up
    call (Omega from seed 0), then ``trials`` timed calls (seeds
    ``trial_seed + t``), each with its normalized error against s_{k+1}."""
    for k in ks:
        for q in qs:
            def omega(t):
                return None if omega_fn is None else omega_fn(k, q, t).to(W.device)

            timed_rsi(W, k, q, omega(None), 0)  # warm
            errs, times = [], []
            for t in range(trials):
                res, dt = timed_rsi(W, k, q, omega(t), trial_seed + t)
                times.append(dt)
                errs.append(float(normalized_error(W, res.U, res.S, res.Vt, float(s[k]), v0=v0)))
            yield k, q, errs, times


def run(full: bool = False, trials: int = 3, ks=(50, 100, 200), qs=(1, 2, 3, 4), *, shape=None, device=None,
        W: Optional[torch.Tensor] = None,
        omega_fn: Optional[Callable[[int, int, Optional[int]], torch.Tensor]] = None,
        v0: Optional[torch.Tensor] = None) -> dict:
    """The figure's grid.  ``shape`` overrides (C, D)."""
    dev = resolve_device(device)
    C, D = shape or ((4096, 25088) if full else (1024, 6272))
    s = vgg_like_spectrum(C, device=dev)
    if W is None:
        W = synth_spectrum_matrix(C, D, s, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    W = W.to(dev)
    if v0 is None:
        v0 = torch.randn((D,), generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    rows = [dict(k=k, q=q, normalized_error=float(np.mean(errs)), err_std=float(np.std(errs)),
                 seconds=float(np.mean(times)), flops=rsi_flops(C, D, k, q))
            for k, q, errs, times in rsi_grid(W, s, ks, qs, trials, 100, omega_fn, v0)]
    return dict(C=C, D=D, rows=rows)


def emit_csv(result):
    for r in result["rows"]:
        print(f"fig4_1/k={r['k']}/q={r['q']},{r['seconds']*1e6:.0f},"
              f"normalized_error={r['normalized_error']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the paper's 4096 x 25088")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(full=args.full, trials=args.trials, device=args.device)
    emit_csv(result)
    return result


if __name__ == "__main__":
    main()
