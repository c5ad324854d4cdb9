"""RSI + LoRA (the paper's closing suggestion, §4): compress the backbone with
RSI, then adapt it with LoRA-style low-rank deltas on top of the FROZEN
factored weights.

    python -m repro_torch.experiments.rsi_plus_lora [--steps 40] [--device cuda|cpu]

The twin of the reference's ``examples/rsi_plus_lora.py``, on the same
reduced llama3.2-1b: every compressed linear W ~= A B stays frozen, and a
trainable delta (``lora_a`` (d_in, r) and ``lora_b`` (r, d_out), r = 4,
``lora_b`` zero at first) is added beside it.  The model sees the merged
leaf (:func:`lora_merge`: the ranks stacked, ``[A, lora_a]`` and ``[B;
lora_b]``), so every forward is one low-rank apply per linear, and only the
adapters receive gradients (AdamW at 5e-3, no weight decay).  Its
assertion: the mean loss of the last five steps is below that of the first
five ("the adapters learn").  The random draws come from explicit
``torch.Generator`` streams seeded as the reference seeds its keys.  Runs on
the card unless ``--device`` cpu is given; ``main(argv)`` returns ``(params,
losses)``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import CompressionPolicy, compress_tree
from repro_torch.core.lowrank import is_lowrank, lowrank_params
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import softmax_xent, tree_from_paths, tree_paths

LORA_RANK = 4


def add_lora(params, generator: torch.Generator):
    """Attach zero-init LoRA adapters to every factored linear."""
    if is_lowrank(params):
        a, b = params["a"], params["b"]
        d_in, d_out, lead = a.shape[-2], b.shape[-1], tuple(a.shape[:-2])
        la = torch.randn(lead + (d_in, LORA_RANK), generator=generator, dtype=torch.float32, device=a.device) * 0.01
        lb = torch.zeros(lead + (LORA_RANK, d_out), dtype=torch.float32, device=b.device)
        return dict(params, lora_a=la.to(a.dtype), lora_b=lb.to(b.dtype))
    if isinstance(params, dict):
        return {k: add_lora(v, generator) for k, v in params.items()}
    return params


def lora_merge(params):
    """Fold the adapters into the factored weights: stack the ranks."""
    if isinstance(params, dict) and "lora_a" in params:
        return lowrank_params(torch.cat([params["a"], params["lora_a"]], dim=-1),
                              torch.cat([params["b"], params["lora_b"]], dim=-2))
    if isinstance(params, dict) and not is_lowrank(params):
        return {k: lora_merge(v) for k, v in params.items()}
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch("llama3.2-1b", reduced=True)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        params, rep = compress_tree(params, CompressionPolicy(alpha=0.4, q=4, min_dim=32),
                                    generator=torch.Generator(device=dev).manual_seed(1))
    print("backbone:", rep.summary())
    params = add_lora(params, torch.Generator(device=dev).manual_seed(2))

    def trainable(path: str) -> bool:
        return "lora" in path

    data = SyntheticLM(cfg, batch=8, seq=32, seed=0)
    opt = opt_mod.adamw(opt_mod.constant_schedule(5e-3), weight_decay=0.0)
    state = opt.init(params)
    losses = []
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.at_step(i).items()}
        live = tree_from_paths((p, t.detach().requires_grad_() if trainable(p) else t) for p, t in tree_paths(params))
        logits, _ = model.forward(lora_merge(live), batch)
        loss = softmax_xent(logits, batch["targets"], real_vocab=cfg.vocab)
        leaves = list(tree_paths(live))
        got = iter(torch.autograd.grad(loss, [t for p, t in leaves if trainable(p)]))
        grads = tree_from_paths([(p, next(got) if trainable(p) else torch.zeros_like(t)) for p, t in leaves])
        with torch.no_grad():
            updates, state = opt.update(grads, state, params, i)
            params = opt_mod.apply_updates(params, updates)
        losses.append(float(loss.detach()))
        if i % 10 == 0:
            print(f"step {i:3d} adapter-only loss {losses[-1]:.4f}")
    if not sum(losses[-5:]) / 5 < sum(losses[:5]) / 5:
        raise AssertionError("LoRA adaptation did not learn")
    n_train = sum(t.numel() for p, t in tree_paths(params) if trainable(p))
    n_total = sum(t.numel() for _, t in tree_paths(params))
    print(f"trainable adapter params: {n_train:,} / {n_total:,} ({n_train / n_total:.2%})")
    print("RSI + LoRA OK")
    return params, losses


if __name__ == "__main__":
    main()
