"""Compression CLI: apply RSI (Alg 3.1) to a model.

    python -m repro_torch.launch.compress --arch llama3.2-1b [--reduced] \\
        [--alpha 0.4 --q 4] [--rank-rule alpha|energy --energy 0.95] \\
        [--min-dim 257] [--errors] [--seed 0] [--device cuda|cpu]

The port's counterpart of ``repro/launch/compress.py``: initializes the
model's params from ``--seed``, compresses every policy-selected linear with
RSI (the sketch GEMMs on the card's kernel), and prints the report's
summary, each compressed layer's rank and parameter counts, and under
``--errors`` the estimated spectral error ||W - AB||_2 of each compressed
leaf (slice 0 of a stacked one).  Runs on the card unless ``--device cpu``
is given.  ``main(argv)`` returns ``(new_params, report)``.  The reference's
``--in-ckpt`` / ``--out-ckpt`` wait for the port's checkpointer.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.4)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--rank-rule", choices=["alpha", "energy"], default="alpha")
    ap.add_argument("--energy", type=float, default=0.95)
    ap.add_argument("--min-dim", type=int, default=257)
    ap.add_argument("--errors", action="store_true", help="estimate spectral errors (slow)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import CompressionPolicy, compress_tree, spectral_norm
    from repro_torch.core.lowrank import is_lowrank, materialize
    from repro_torch.models.model import build_model

    cfg = get_arch(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))

    policy = CompressionPolicy(alpha=args.alpha, q=args.q, rank_rule=args.rank_rule, energy=args.energy,
                               min_dim=args.min_dim)
    new_params, rep = compress_tree(params, policy, generator=torch.Generator(device=dev).manual_seed(1))
    print(rep.summary())
    for layer in rep.layers:
        if layer.compressed:
            print(f"  {layer.path:48s} {str(layer.shape):>22s} rank={layer.rank:4d} "
                  f"params {layer.params_before/1e6:8.2f}M -> {layer.params_after/1e6:8.2f}M")

    if args.errors:
        flat_old = dict(_walk(params))
        for path, leaf in _walk(new_params):
            if is_lowrank(leaf):
                W = flat_old[path]
                if W.dim() > 2:
                    W = W.reshape((-1,) + tuple(W.shape[-2:]))[0]
                    leaf = {k: v.reshape((-1,) + tuple(v.shape[-2:]))[0] for k, v in leaf.items()}
                # one seed for every leaf, as the reference passes one key
                err = float(spectral_norm(W - materialize(leaf), torch.Generator(device=dev).manual_seed(2)))
                print(f"  spectral err {path}: {err:.4f}")
    return new_params, rep


def _walk(tree, prefix=""):
    from repro_torch.core.lowrank import is_lowrank

    if is_lowrank(tree) or not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _walk(v, f"{prefix}/{k}" if prefix else k)


if __name__ == "__main__":
    main()
