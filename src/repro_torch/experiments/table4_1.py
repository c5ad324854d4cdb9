"""Table 4.1: end-to-end compression vs predictive accuracy.

    python -m repro_torch.experiments.table4_1 [--device cuda|cpu]

The twin of the reference's ``benchmarks/table4_1.py``.  A small MLP
classifier (VGG-classifier-shaped: three FC layers, ``DIMS``) is trained
with torch autograd on a synthetic 10-class dataset (400 steps of AdamW
under a cosine schedule, batches of 256 from ``np.random.default_rng(0)``).
Its hidden weight is then blended with a matrix of the published slow-decay
spectrum (Fig 1.1) and the whole model is refit (200 steps), isolating the
spectral mechanism the paper attributes the q-effect to.  The paper's
alpha x q grid then compresses it with no retraining
(``CompressionPolicy(min_dim=64, break_even_only=False)``) and reports
seconds, ratio, top-1 and top-5.  Every linear runs through
``core.lowrank.apply_linear``, so on the card the compressed forward runs the
``lowrank_matmul`` kernel.

As in the reference, the test set is drawn from the TRAIN set's class means
with ``np.random.default_rng(123)``.

Randomness hooks: ``init_params`` (the MLP's init, a tree of arrays or
tensors), ``blend_fn(i, shape)`` (the slow-decay matrix of layer ``i``),
``omega_fn`` (as ``compress_tree`` takes it, one for every cell, as the
reference compresses every cell from one key) and ``trained_params`` (skip
training and the blend: compress these).  Otherwise the init comes from
seed 0, the blend matrix of layer i from seed 40 + i, and every cell's
Omegas from a generator seeded 7.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import CompressionPolicy, apply_linear, compress_tree, synth_spectrum_matrix, vgg_like_spectrum
from repro_torch.data.synthetic import classification_dataset
from repro_torch.experiments.fig4_1 import wait
from repro_torch.runtime.device import resolve_device
from repro_torch.train import optimizer as opt_mod

__all__ = ["DIMS", "MARGIN", "init_mlp", "mlp_features", "mlp_forward", "train_mlp", "accuracy", "datasets", "run",
           "emit_csv"]

DIMS = (256, 512, 512, 10)  # "VGG classifier"-shaped FC stack (scaled)
MARGIN = 0.18  # class-mean scale: tuned so the uncompressed model sits ~80% top-1


def init_mlp(generator: torch.Generator, dims=DIMS, device=None) -> dict:
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"fc{i}"] = {"w": torch.randn((a, b), generator=generator, device=device) * (a**-0.5),
                            "b": torch.zeros((b,), device=device)}
    return params


def mlp_features(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The penultimate features h(x): every layer but the head, each with GELU."""
    for i in range(len(params) - 1):
        p = params[f"fc{i}"]
        x = F.gelu(apply_linear(p["w"], x) + p["b"], approximate="tanh")  # jax.nn.gelu's default
    return x


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params[f"fc{len(params) - 1}"]
    return apply_linear(head["w"], mlp_features(params, x)) + head["b"]


def train_mlp(params: dict, X: torch.Tensor, y: torch.Tensor, *, steps: int = 400, lr: float = 3e-3) -> dict:
    """AdamW (no weight decay) under ``cosine_schedule(lr, 20, steps)`` on
    cross-entropy, batches of 256 indices from ``default_rng(0)``."""
    opt = opt_mod.adamw(opt_mod.cosine_schedule(lr, 20, steps), weight_decay=0.0)
    state = opt.init(params)
    n = X.shape[0]
    rng = np.random.default_rng(0)
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=256), device=X.device)
        xb, yb = X[idx], y[idx]
        params = {n: {k: t.detach().requires_grad_(True) for k, t in p.items()} for n, p in params.items()}
        logits = mlp_forward(params, xb)
        loss = -torch.mean(torch.gather(F.log_softmax(logits, dim=-1), 1, yb[:, None].long()))
        loss.backward()
        grads = {n: {k: t.grad for k, t in p.items()} for n, p in params.items()}
        with torch.no_grad():
            updates, state = opt.update(grads, state, params, i)
            params = opt_mod.apply_updates(params, updates)
    return params


@torch.no_grad()
def accuracy(params: dict, X: torch.Tensor, y: torch.Tensor, topk=(1, 5)) -> dict:
    logits = mlp_forward(params, X)
    order = torch.argsort(-logits, dim=-1, stable=True)
    return {f"top{k}": float(torch.mean(torch.any(order[:, :k] == y[:, None], dim=1).float())) for k in topk}


def datasets(n_train: int = 8192, n_test: int = 2048):
    """(Xtr, ytr, Xte, yte) as numpy: the test set drawn from the train set's
    class means with ``default_rng(123)``, as the reference draws it."""
    Xtr, ytr, means = classification_dataset(0, n_train, DIMS[0], DIMS[-1], margin=MARGIN)
    rng = np.random.default_rng(123)
    yte = rng.integers(0, DIMS[-1], size=n_test).astype(np.int32)
    Xte = means[yte] + rng.standard_normal((n_test, DIMS[0])).astype(np.float32)
    return Xtr, ytr, Xte, yte


def _tensors(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(tree, dtype=np.float32), device=dev)


def run(alphas=(0.8, 0.6, 0.4, 0.2), qs=(1, 2, 3, 4), synthetic_spectrum: bool = True, *, steps: int = 400,
        refit_steps: int = 200, n_test: int = 2048, device=None, init_params: Any = None,
        blend_fn: Optional[Callable[[int, tuple], torch.Tensor]] = None,
        omega_fn: Optional[Callable[[str, Optional[int], tuple], torch.Tensor]] = None,
        trained_params: Any = None) -> dict:
    """The table's grid; returns the baseline's accuracy, each cell's row and
    the (uncompressed) params the grid compressed."""
    dev = resolve_device(device)
    Xtr, ytr, Xte, yte = datasets(n_test=n_test)
    Xtr, ytr = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
    Xte, yte = torch.as_tensor(Xte, device=dev), torch.as_tensor(yte, device=dev)

    if trained_params is not None:
        params = _tensors(trained_params, dev)
    else:
        if init_params is None:
            params = init_mlp(torch.Generator(device=dev).manual_seed(0), device=dev)
        else:
            params = _tensors(init_params, dev)
        params = train_mlp(params, Xtr, ytr, steps=steps)
        if synthetic_spectrum:
            # swap hidden weights for blends with slow-decay-spectrum matrices, then
            # refit so the model is accurate again
            for i in range(1, len(DIMS) - 2):
                a, b = DIMS[i], DIMS[i + 1]
                if blend_fn is not None:
                    W = blend_fn(i, (a, b)).to(dev)
                else:
                    W = synth_spectrum_matrix(a, b, vgg_like_spectrum(min(a, b), device=dev),
                                              generator=torch.Generator(device=dev).manual_seed(40 + i), device=dev)
                w = params[f"fc{i}"]["w"]
                params[f"fc{i}"]["w"] = 0.5 * w + 0.5 * W / torch.linalg.norm(W) * torch.linalg.norm(w)
            params = train_mlp(params, Xtr, ytr, steps=refit_steps)

    base = accuracy(params, Xte, yte)
    rows = []
    for alpha in alphas:
        for q in qs:
            policy = CompressionPolicy(alpha=alpha, q=q, min_dim=64, break_even_only=False)
            gen = None if omega_fn is not None else torch.Generator(device=dev).manual_seed(7)
            wait(dev)
            t0 = time.perf_counter()
            newp, rep = compress_tree(params, policy, generator=gen, omega_fn=omega_fn)
            wait(dev)
            dt = time.perf_counter() - t0
            acc = accuracy(newp, Xte, yte)
            rows.append(dict(alpha=alpha, q=q, seconds=dt, ratio=rep.ratio, top1=acc["top1"], top5=acc["top5"]))
    return dict(baseline=base, rows=rows, params=params)


def emit_csv(result):
    b = result["baseline"]
    print(f"table4_1/baseline,0,top1={b['top1']:.4f};top5={b['top5']:.4f}")
    for r in result["rows"]:
        print(f"table4_1/alpha={r['alpha']}/q={r['q']},{r['seconds']*1e6:.0f},"
              f"ratio={r['ratio']:.3f};top1={r['top1']:.4f};top5={r['top5']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(device=args.device)
    emit_csv(result)
    return result


if __name__ == "__main__":
    main()
