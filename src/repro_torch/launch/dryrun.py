"""Dry-run: one rank's real step of every (arch x shape x mesh) cell, counted.

The port's counterpart of ``repro/launch/dryrun.py``.  For each cell this
builds the REAL step (the train step for train shapes, the prefill and
decode steps for inference shapes) that one rank of the production mesh
runs, 16 x 16 = 256 ranks or 2 x 16 x 16 = 512, inside the dry world
(``roofline/dry.py``: every tensor a fake, nothing allocated, the dispatch
on the card's branches), counts it with ``roofline/op_stats.py`` and prices
the counts at one H100's data-sheet figures (``roofline/analysis.py``).
Results go to ``--out`` (default ``build/dryrun_results/``), one JSON file a
cell under the mesh's tag.

What one rank runs is what the port runs on a live mesh, its rows of the
global batch (split over ("pod", "data") where they divide) and the
collectives of ``runtime/distributed.py`` on a dry mesh, in one of two
programs.  The dense family and the moe family without MLA run the
tensor-parallel program (``sharding/rules.py``): the rank
holds its blocks of the params and optimizer state under the reference's
specs, FSDP blocks gathered over "data" just before their products, the
linears column- and row-parallel over "model", the embedding and head
vocab-parallel, the sequence over "model" between blocks in train and
prefill cells, the experts as its "ep" block, the decode cache's slots
over "model" (``cache_specs``), the gradient mean over the batch axes.  The other archs (MLA, the SSM families, the vlm and the
encoder-decoder) keep the whole-param program: every param whole on
every rank, the MoE layers expert-parallel over "model", the train step's
gradient mean over the world.  Rank 0 stands for all ranks.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --skip-existing

A cell's record has the reference's keys.  Two of them have no XLA here:
``lower_s`` is the seconds to build the step on fakes and ``compile_s``
the seconds of the counted run; ``xla_cost_analysis_flops_raw`` and
``hlo_bytes`` are null.  Beside them: ``collectives_by_axis``,
``kernels`` (op -> calls, FLOPs, bytes), ``matmul_flops_per_chip``,
``argument_bytes``, ``peak_bytes`` and ``fits`` (the peak within
``HW.HBM_PER_CHIP``), ``card`` and ``sharded_by_reference_bytes`` (the
bytes of the param and optimizer leaves this rank holds whole that the
reference's ``param_specs`` splits over the mesh: 0 under the
tensor-parallel program, what the whole-param program costs in memory
elsewhere).  A cell that does not fit
is a result, not a failure; a cell that cannot run prints FAIL and the run
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.configs.registry import ARCH_IDS, all_cells, cell_is_runnable, get_arch, get_shape
from repro_torch.launch.mesh import HW, make_production_mesh, make_rules
from repro_torch.models.model import analytic_param_count, batch_spec_template, build_model
from repro_torch.roofline import dry, op_stats
from repro_torch.roofline.analysis import axis_bandwidth, roofline_terms
from repro_torch.runtime.dispatch import DispatchConfig, use_dispatch
from repro_torch.runtime.distributed import MeshSpec, axis_names, dry_mesh
from repro_torch.sharding.rules import layout_specs, param_specs, shard_params, tensor_parallel, use_rules
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import TrainState, make_train_step, state_specs
from repro_torch.tree import tree_map, tree_paths

__all__ = ["RESULTS_DIR", "MESH_TAGS", "input_specs", "build_step", "run_cell", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_results")
MESH_TAGS = {False: "single_pod_16x16", True: "multi_pod_2x16x16"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def local_rows(cell: ShapeCell, rules) -> int:
    """This rank's rows of the cell's global batch: split over the batch
    axes where they divide it, else the whole batch (``long_500k``'s one)."""
    axes = None if rules is None else rules.resolve("batch", cell.global_batch)
    return cell.global_batch // rules.axis_size(axis_names(axes)) if axes else cell.global_batch


def input_specs(cfg: ArchConfig, cell: ShapeCell, rows: int, device) -> dict:
    """Zero tensors of every model input of one rank's ``rows`` of a cell
    (fakes inside the dry world)."""
    tmpl = batch_spec_template(cfg, rows, cell.seq_len, kind=cell.kind)
    return {k: torch.zeros(shape, dtype=dtype, device=device) for k, (shape, dtype) in tmpl.items()}


def _make_optimizer(cfg):
    sched = opt_mod.cosine_schedule(3e-4, 2000, 100_000)
    if cfg.optimizer == "adafactor":
        return opt_mod.adafactor(sched)
    if cfg.optimizer == "sgdm":
        return opt_mod.sgdm(sched)
    return opt_mod.adamw(sched)


def build_step(arch: Union[str, ArchConfig], shape: Union[str, ShapeCell], mesh: Optional[MeshSpec], *,
               reduced: bool = False, rank: int = 0, device=None, seed: int = 0,
               max_len: Optional[int] = None) -> tuple:
    """(step, arguments, meta, rules) of one cell on rank ``rank`` of
    ``mesh`` (None: one card, no rules).  ``step()`` runs the cell's step
    once under the arch's kernel policy (prefill and decode without grad);
    ``arguments`` is its inputs' tree (params, optimizer state or cache,
    batch).  A prefill's cache holds ``max_len`` positions (default the
    cell's ``seq_len``).  Inside the dry world everything is a fake and the
    mesh a dry one; outside it the same step runs for real on ``device``
    (default the card)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch, reduced=reduced)
    cell = shape if isinstance(shape, ShapeCell) else get_shape(shape)
    rules = None
    sharded = mesh is not None and tensor_parallel(cfg)
    if mesh is not None:
        rules = make_rules(dry_mesh(mesh, rank, device), sequence_parallel=cell.kind != "decode")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    specs = whole = None
    if sharded:  # this rank's blocks; the whole leaves' shapes stay behind as meta tensors
        specs = layout_specs(params, rules)
        whole = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
        params = shard_params(params, rules, specs=specs)
    rows = local_rows(cell, rules)
    batch = input_specs(cfg, cell, rows, model.device)
    policy = DispatchConfig.from_arch(cfg)

    if cell.kind == "train":
        opt = _make_optimizer(cfg)
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=torch.zeros((), dtype=torch.int32, device=model.device))
        if whole is not None:
            whole = TrainState(params=whole, opt_state=opt.init(whole), step=state.step)
        fn = make_train_step(model, opt, rules=rules, accum_steps=cfg.accum_steps, specs=specs)
        arguments = (state, batch)

        def step():
            with use_dispatch(policy):
                return fn(state, batch)
    elif cell.kind == "prefill":
        fn = make_prefill_step(model, rules=rules, max_len=max_len or cell.seq_len)
        arguments = (params, batch)

        def step():
            with use_dispatch(policy), torch.no_grad():
                return fn(params, batch)
    elif cell.kind == "decode":
        with use_rules(rules):  # this rank's block of the cache under tensor-parallel rules
            cache = model.init_cache(rows, cell.seq_len)
        fn = make_decode_step(model, rules=rules)
        pos = cell.seq_len - 1  # the cache's last position: every row of it valid
        arguments = (params, cache, batch)

        def step():
            with use_dispatch(policy), torch.no_grad():
                return fn(params, cache, batch["tokens"], pos)
    else:
        raise ValueError(cell.kind)

    n_params = analytic_param_count(cfg)
    n_active = analytic_param_count(cfg, active_only=True)
    meta = {
        "arch": arch if isinstance(arch, str) else cfg.name,
        "shape": cell.name,
        "kind": cell.kind,
        "tokens": cell.tokens,
        "n_params": n_params,
        "n_params_active": n_active,
        "model_flops_global": _model_flops(cfg, cell, n_params, n_active),
        "rows_per_rank": rows,
        "tensor_parallel": sharded,
    }
    if rules is not None:
        meta["sharded_by_reference_bytes"] = sharded_by_reference_bytes(arguments, rules, cell.kind, whole)
    return step, arguments, meta, rules


def _model_flops(cfg, cell, n_params, n_active):
    """6*N*D (train: fwd+bwd), 2*N*D (inference fwd only), N = active params."""
    mult = 6 if cell.kind == "train" else 2
    return mult * n_active * cell.tokens


def sharded_by_reference_bytes(arguments, rules, kind: str, whole=None) -> int:
    """Bytes of the param (and, for a train step, optimizer-state) leaves
    this rank holds whole that the reference's specs split over the mesh.
    ``whole``: the same tree (a TrainState, or the params) with every leaf
    whole (meta tensors will do), where ``arguments`` hold blocks."""
    held = arguments[0]
    ref = held if whole is None else whole
    if kind == "train":
        specs = state_specs(ref, rules)
        pairs = [(held.params, ref.params, specs.params), (held.opt_state, ref.opt_state, specs.opt_state)]
    else:
        pairs = [(held, ref, param_specs(ref, rules))]
    total = 0
    for tree, ref_tree, spec_tree in pairs:
        specs, shapes = dict(tree_paths(spec_tree)), {p: tuple(t.shape) for p, t in tree_paths(ref_tree)}
        for path, leaf in tree_paths(tree):
            if any(e is not None for e in specs.get(path, ())) and tuple(leaf.shape) == shapes[path]:
                total += leaf.numel() * leaf.element_size()
    return total


def count_cell(arch, shape, mesh: Optional[MeshSpec], *, reduced: bool = False,
               max_len: Optional[int] = None) -> tuple:
    """Build and count one cell inside a fresh dry world: (OpStats, meta,
    sharded_by_reference_bytes, build seconds, run seconds)."""
    with dry.dry_world():
        t0 = time.time()
        step, arguments, meta, rules = build_step(arch, shape, mesh, reduced=reduced, max_len=max_len)
        t_build = time.time() - t0
        t0 = time.time()
        _, stats = op_stats.measure(step, arguments=arguments)
        t_run = time.time() - t0
        sharded = meta.pop("sharded_by_reference_bytes", 0)
    return stats, meta, sharded, t_build, t_run


def run_cell(arch_id, shape_name, *, multi_pod: bool, reduced: bool = False, save: bool = True,
             out: str = RESULTS_DIR) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    tag = MESH_TAGS[multi_pod]
    stats, meta, sharded, t_build, t_run = count_cell(arch_id, shape_name, mesh, reduced=reduced)
    rates = {a: axis_bandwidth(mesh, a) for a in stats.coll_by_axis}
    rf = roofline_terms(
        flops=stats.flops,
        hbm_bytes=stats.hbm_bytes,
        coll_bytes=stats.coll_by_axis,
        chips=chips,
        model_flops_global=meta["model_flops_global"],
        ici_bw=rates,
    )
    result = {
        **meta,
        "mesh": tag,
        "chips": chips,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "flops_per_chip": stats.flops,
        "matmul_flops_per_chip": stats.matmul_flops,
        "xla_cost_analysis_flops_raw": None,
        "hbm_bytes_per_chip": stats.hbm_bytes,
        "collective_bytes_per_chip": stats.total_coll_bytes,
        "collectives_by_kind": stats.coll_bytes,
        "collectives_by_axis": stats.coll_by_axis,
        "collective_rate_by_axis": rates,
        "collective_op_count": stats.coll_ops,
        "memory": {"argument_bytes": stats.argument_bytes, "peak_bytes": stats.peak_bytes,
                   "total_bytes": stats.peak_bytes},
        "argument_bytes": stats.argument_bytes,
        "peak_bytes": stats.peak_bytes,
        "fits": stats.peak_bytes <= HW.HBM_PER_CHIP,
        "sharded_by_reference_bytes": sharded,
        "kernels": stats.kernels,
        "t_compute": rf.t_compute,
        "t_memory": rf.t_memory,
        "t_collective": rf.t_collective,
        "bottleneck": rf.bottleneck,
        "useful_flops_ratio": rf.useful_flops_ratio,
        "roofline_fraction": rf.roofline_fraction,
        "hlo_bytes": None,
        "card": HW.NAME,
    }
    if save:
        outdir = os.path.join(os.path.abspath(out), tag)
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{arch_id}__{shape_name}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=SHAPES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="debug: tiny configs")
    ap.add_argument("--out", default=RESULTS_DIR, help="results directory (default build/dryrun_results/)")
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else None
    if cells is None:
        if not args.arch:
            ap.error("--arch/--shape or --all required")
        shapes = [args.shape] if args.shape else [s for s in SHAPES if cell_is_runnable(args.arch, s)[0]]
        cells = [(args.arch, s) for s in shapes]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for arch_id, shape_name in cells:
        ok, why = cell_is_runnable(arch_id, shape_name)
        if not ok:
            print(f"SKIP  {arch_id:24s} {shape_name:12s} ({why})")
            continue
        for mp in meshes:
            tag = MESH_TAGS[mp]
            out = os.path.join(os.path.abspath(args.out), tag, f"{arch_id}__{shape_name}.json")
            if args.skip_existing and os.path.exists(out):
                print(f"HAVE  {arch_id:24s} {shape_name:12s} {tag}")
                continue
            try:
                r = run_cell(arch_id, shape_name, multi_pod=mp, reduced=args.reduced, out=args.out)
                print(
                    f"OK    {arch_id:24s} {shape_name:12s} {tag:18s} "
                    f"run={r['compile_s']:7.1f}s  bottleneck={r['bottleneck']:10s} "
                    f"t=({r['t_compute']:.3f},{r['t_memory']:.3f},{r['t_collective']:.3f})s "
                    f"peak={r['peak_bytes'] / 2**30:.2f}GiB/chip fits={r['fits']}",
                    flush=True,
                )
            except Exception as e:  # a cell that cannot run is reported and the sweep goes on
                failures.append((arch_id, shape_name, tag, repr(e)))
                print(f"FAIL  {arch_id:24s} {shape_name:12s} {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", *f[:3])
        raise SystemExit(1)
    print("\nall requested cells counted.")


if __name__ == "__main__":
    main()
