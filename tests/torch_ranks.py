"""The rank program of ``tests/test_torch_distributed.py``.

``runtime.distributed.spawn`` pickles the function it runs by reference,
so it lives in a module of its own that imports neither jax nor the
reference: each of the eight CPU ranks imports only torch and the port.
Every part runs at the reference's test sizes (``tests/test_distributed.py``)
on the inputs the reference drew, handed over as CPU tensors.
"""

import dataclasses
import os

import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.core import gradient_compression as gc
from repro_torch.core.distributed_rsi import distributed_rsi
from repro_torch.core.rsi import QR_FALLBACKS
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_rules
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.runtime import distributed
from repro_torch.runtime.distributed import MeshSpec, NamedSharding, local_block
from repro_torch.sharding.rules import MeshRules, layout_specs, shard_params, use_rules
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train.pipeline_parallel import gpipe_apply

RSI_K, RSI_Q = 32, 3
TSQR_K, TSQR_Q = 170, 3  # the energy rule's probe rank and q on the sharp spectrum
PIPE_MICROBATCHES = 4
POWERSGD = gc.PowerSGDConfig(rank=8, min_size=1024)
TRAIN_LR = 1e-2  # SGD with momentum: the step's update is linear in the gradient
# the tensor-parallel cases: tag -> (arch, optimizer), reduced and in fp32.  llama3.2-1b holds half a
# KV head a rank at (2, 4) (wk's 32 columns over 4: 8 of a 16-wide head), minitron-4b's 3 query heads
# do not divide 4, phi3.5-moe's 4 experts lie one a rank; h2o-danube-1.8b's ring, its window cut to 8,
# holds 2 slots a rank of a 16-token prompt's last 8; tp_whole's widths divide no split over 4 (3 heads
# of 18 and 1 KV head: 54 and 18 columns; d_ff 130) and its 22-slot cache does not either, so every
# linear and the cache take the reference's fallback to whole over "model"
TP_CASES = {"tp_llama": ("llama3.2-1b", "adamw"), "tp_minitron": ("minitron-4b", "adafactor"),
            "tp_phi": ("phi3.5-moe-42b-a6.6b", "adamw"), "tp_llama_rsi": ("llama3.2-1b", "adamw"),
            "tp_danube": ("h2o-danube-1.8b", "adamw"), "tp_whole": ("llama3.2-1b", "adamw")}
# each case's changes to the reduced config (dataclasses.replace)
TP_CFG = {"tp_danube": dict(sliding_window=8), "tp_whole": dict(n_heads=3, n_kv_heads=1, head_dim=18, d_ff=130)}
# the cases whose params the reference RSI-compresses first (compress_tree at TP_RSI, its specs transformed):
# column-parallel factored linears, row-parallel ones summing their (tokens, k) intermediate
TP_RSI = {"tp_llama_rsi": dict(alpha=0.25, q=2, min_dim=8)}
TP_MAX_LEN = 24
TP_MAX_LENS = {"tp_whole": 22}  # the prefill's max_len where not TP_MAX_LEN
# the cases whose train step runs with the sequence whole (the prefill keeps it over "model"): tp_whole's
# row linears then leave their region with the whole cotangent on one rank of "model"
TP_TRAIN_SEQ = {"tp_whole": False}


def tp_cfg(tag: str):
    """The reduced fp32 config of the tensor-parallel case ``tag``."""
    return dataclasses.replace(get_arch(TP_CASES[tag][0], reduced=True), dtype="float32", capacity_factor=8.0,
                               **TP_CFG.get(tag, {}))


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = v
    return tree


def _tanh_block(w, h):
    return torch.tanh(h @ w)


def _grads(tree: dict, prefix: str = "") -> dict:
    """path -> gradient (numpy) of every leaf of a tree of tensors."""
    out = {}
    for path, t in t_ts.tree_paths(tree, prefix):
        out[path] = t.grad.numpy()
    return out


def ranks(mesh, ref: dict, ckpt_dir: str) -> dict:
    """Every part on this rank; returns numpy arrays and counts."""
    rank = mesh.rank
    out = {}

    # distributed RSI on (2, 4) ("data", "model")
    W = _t(ref["rsi_W"])
    blk = local_block(W, ("data", "model"), mesh, rank)
    res = distributed_rsi(blk, RSI_K, RSI_Q, omega=_t(ref["rsi_omega"]))
    out["rsi"] = {"U": res.U.numpy(), "S": res.S.numpy(), "Vt": res.Vt.numpy()}

    # the TSQR redo: the sharp spectrum whose fp32 Gram breaks down
    QR_FALLBACKS.reset()
    Wsharp = _t(ref["tsqr_W"])
    res = distributed_rsi(local_block(Wsharp, ("data", "model"), mesh, rank), TSQR_K, TSQR_Q,
                          omega=_t(ref["tsqr_omega"]))
    out["tsqr"] = {"U": res.U.numpy(), "S": res.S.numpy(), "Vt": res.Vt.numpy(), "fallbacks": QR_FALLBACKS.count}

    # expert-parallel MoE on the same mesh: tokens over "data", experts over "model"
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), n_experts=8, capacity_factor=8.0)
    p = params_from_numpy(_unflatten({k: v.numpy() for k, v in ref.items()}, "moe_p/"), "cpu")
    rules = MeshRules(mesh)
    x = _t(ref["moe_x"])
    x_loc = local_block(x, rules.spec(("batch", None, None), tuple(x.shape)), mesh, rank)
    with use_rules(rules), torch.no_grad():
        y, aux = moe.moe_forward(p, x_loc, cfg)
    out["moe"] = {"y": y.numpy(), "aux": float(aux)}
    # its backward: this rank's loss, the mean over its tokens of <y, w> plus the aux loss
    for t in (v for _, v in t_ts.tree_paths(p)):
        t.requires_grad_()
    xg = x_loc.clone().requires_grad_()
    w_loc = local_block(_t(ref["moe_w"]), rules.spec(("batch", None, None), tuple(x.shape)), mesh, rank)
    with use_rules(rules):
        yg, auxg = moe.moe_forward(p, xg, cfg)
    (torch.mean(torch.sum(yg * w_loc, -1)) + auxg).backward()
    out["moe"].update(grads=_grads(p), gx=xg.grad.numpy())

    # GPipe over "pod": 4 stages; the two "data" rows run the same pipeline
    pipe = distributed.make_mesh((2, 4), ("data", "pod"))
    ws, xp = _t(ref["pipe_ws"]), _t(ref["pipe_x"])
    with distributed.use_mesh(pipe):
        got = gpipe_apply(_tanh_block, n_microbatches=PIPE_MICROBATCHES)(local_block(ws, ("pod",), pipe, rank), xp)
    seq = []
    for mb in xp.reshape(PIPE_MICROBATCHES, -1, xp.shape[-1]):
        for w in ws:
            mb = _tanh_block(w, mb)
        seq.append(mb)
    out["pipe"] = {"y": got.numpy(), "seq": torch.cat(seq).numpy()}
    # its backward: every stage's loss <y, wo>
    wl = local_block(ws, ("pod",), pipe, rank).clone().requires_grad_()
    xg = xp.clone().requires_grad_()
    with distributed.use_mesh(pipe):
        yg = gpipe_apply(_tanh_block, n_microbatches=PIPE_MICROBATCHES)(wl, xg)
    torch.sum(yg * _t(ref["pipe_wo"])).backward()
    # only the first stage reads x
    out["pipe"].update(gws=wl.grad.numpy(), gx=(xg.grad if xg.grad is not None else torch.zeros_like(xg)).numpy())

    # one step of make_train_step(rules=) on a reduced phi3.5-moe: the tensor-parallel program on this
    # rank's blocks (EP layers, the batch over "data"), the sequence whole
    tcfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b", reduced=True), dtype="float32", capacity_factor=8.0)
    model, opt = build_model(tcfg, device="cpu"), t_opt.sgdm(t_opt.constant_schedule(TRAIN_LR))
    params = params_from_numpy(_unflatten({k: v.numpy() for k, v in ref.items()}, "ts_p/"), "cpu")
    specs = layout_specs(params, rules)
    blocks = shard_params(params, rules, specs=specs)
    state = t_ts.TrainState(params=blocks, opt_state=opt.init(blocks), step=torch.zeros((), dtype=torch.int32))
    batch = shard_batch({"tokens": ref["ts_tokens"], "targets": ref["ts_targets"]}, rules)
    state, m = t_ts.make_train_step(model, opt, rules=rules, specs=specs)(state, batch)
    out["train"] = {"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: v.numpy() for k, v in t_ts.tree_paths(state.params)},
                    "specs": {k: tuple(v) for k, v in t_ts.tree_paths(specs)}}

    # the same step in the whole-param program: reduced deepseek-v2 (MLA), every param whole on every rank
    wcfg = dataclasses.replace(get_arch("deepseek-v2-236b", reduced=True), dtype="float32", capacity_factor=8.0)
    params = params_from_numpy(_unflatten({k: v.numpy() for k, v in ref.items()}, "wp_p/"), "cpu")
    state = t_ts.TrainState(params=params, opt_state=opt.init(params), step=torch.zeros((), dtype=torch.int32))
    batch = shard_batch({"tokens": ref["wp_tokens"], "targets": ref["wp_targets"]}, rules)
    state, m = t_ts.make_train_step(build_model(wcfg, device="cpu"), opt, rules=rules)(state, batch)
    out["whole_train"] = {"metrics": {k: float(v) for k, v in m.items()},
                          "params": {k: v.numpy() for k, v in t_ts.tree_paths(state.params)}}

    # PowerSGD over 8 data ranks, from the reference's initial Q
    dp = distributed.make_mesh((8,), ("data",))
    g = {"w": _t(ref["psgd_grads"][rank])}
    with distributed.use_mesh(dp):
        state = gc.init_powersgd(g, POWERSGD, qs={"w": _t(ref["psgd_q"])})
        mean, _ = gc.compress_allreduce(g, state, "data", POWERSGD)
    out["psgd"] = {"y": mean["w"].numpy(), "bytes": gc.comm_bytes(g, POWERSGD)}

    # the elastic reshard: saved from (2, 4), restored onto (8, 1)
    W2 = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    saved = {"w": local_block(W2, ("data", "model"), mesh, rank).clone()}
    ckpt.save(saved, ckpt_dir, 3, codec="raw", shardings={"w": NamedSharding(mesh, ("data", "model"))})
    target = MeshSpec((8, 1), ("data", "model"))
    restored, _ = ckpt.restore(saved, ckpt_dir, shardings={"w": NamedSharding(target, ("data", "model"))})
    out["reshard"] = {"w": restored["w"].numpy(), "files": sorted(os.listdir(ckpt_dir))}

    for tag in TP_CASES:
        out[tag] = tensor_parallel_case(mesh, ref, tag)
    return out


def tensor_parallel_case(mesh, ref: dict, tag: str) -> dict:
    """One tensor-parallel case on this rank: its blocks of the reference's
    params, one train step, a prefill and one decode step on them (the
    collectives of each part counted as ``distributed.collective_counts``)."""
    opt_name = TP_CASES[tag][1]
    cfg = tp_cfg(tag)
    model = build_model(cfg, device="cpu")
    opt = (t_opt.adafactor if opt_name == "adafactor" else t_opt.adamw)(t_opt.constant_schedule(TRAIN_LR))
    params = params_from_numpy(_unflatten({k: v.numpy() for k, v in ref.items()}, tag + "_p/"), "cpu")
    rules = make_rules(mesh, sequence_parallel=True)
    specs = layout_specs(params, rules)
    blocks = shard_params(params, rules, specs=specs)
    out = {"shapes": {k: tuple(v.shape) for k, v in t_ts.tree_paths(blocks)},
           "specs": {k: tuple(v) for k, v in t_ts.tree_paths(specs)},
           "whole": {k: tuple(v.shape) for k, v in t_ts.tree_paths(params)}}
    state = t_ts.TrainState(params=blocks, opt_state=opt.init(blocks), step=torch.zeros((), dtype=torch.int32))
    batch = shard_batch({"tokens": ref[tag + "_tokens"], "targets": ref[tag + "_targets"]}, rules)
    trules = make_rules(mesh, sequence_parallel=TP_TRAIN_SEQ.get(tag, True))
    distributed.reset_collective_counts()
    new, m = t_ts.make_train_step(model, opt, rules=trules, specs=specs)(state, batch)
    out["train_collectives"] = distributed.collective_counts()
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = {k: v.numpy() for k, v in t_ts.tree_paths(new.params)}
    with torch.no_grad():
        logits, cache = make_prefill_step(model, rules=rules, max_len=TP_MAX_LENS.get(tag, TP_MAX_LEN))(
            blocks, {"tokens": batch["tokens"]})
        drules = make_rules(mesh, sequence_parallel=False)
        dlogits, cache = make_decode_step(model, rules=drules)(blocks, cache, batch["tokens"][:, -1:],
                                                              batch["tokens"].shape[1])
    out.update(prefill=logits.numpy(), decode=dlogits.numpy(),
               cache={k: v.numpy() for k, v in t_ts.tree_paths(cache)})
    return out


def rank_of(mesh) -> int:
    """The smallest rank program: this rank's index."""
    return mesh.rank


def collective_shapes(mesh) -> dict:
    """(shape, dtype) of what each collective returns on this rank of a
    (data, model) mesh: run by live gloo ranks and by the dry mesh
    (``tests/test_torch_roofline.py``), which must agree."""
    def sig(t):
        return None if t is None else (tuple(t.shape), str(t.dtype))

    x = torch.zeros((2, 3), dtype=torch.float32, device=mesh.device) + mesh.rank
    h = torch.zeros((4,), dtype=torch.bfloat16, device=mesh.device)
    out = {"psum": sig(distributed.psum(x, "model", mesh)),
           "psum_both": sig(distributed.psum(h, ("data", "model"), mesh)),
           "pmean": sig(distributed.pmean(x, "data", mesh)),
           "all_gather": sig(distributed.all_gather(h, "model", mesh))}
    parts = distributed.gather_to_first(x, mesh)
    out["gather_to_first"] = None if parts is None else [sig(p) for p in parts]
    first = distributed.axis_index("data", mesh) == 0
    token = distributed.shift_token(mesh.device, False)
    got, token = distributed.shift(x if first else None, "data", send=first, recv_like=None if first else x,
                                   token=token, mesh=mesh)
    out["shift"] = sig(got)
    out["token"] = sig(token)
    return out
