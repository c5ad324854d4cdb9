"""Roofline table: the dry-run's cell records as one markdown table or CSV rows.

The port's counterpart of ``benchmarks/roofline_table.py``, over
``launch/dryrun.py``'s ``--out`` directory.  The numbers are counts of the
port's per-rank program priced at one H100's data-sheet figures
(``launch/mesh.py::HW``); none is a card measurement.

Usage:
    PYTHONPATH=src python -m repro_torch.roofline.table [--mesh single_pod_16x16|multi_pod_2x16x16|both]
        [--markdown] [--out DIR]
Emits a markdown table, or CSV rows (name,us_per_call,derived).  ``--mesh
both`` gives one row a cell with each column "16 x 16 / 2 x 16 x 16".
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR

__all__ = ["load", "markdown", "markdown_both", "emit_csv", "main"]

_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(mesh_tag: str, out: str = RESULTS_DIR) -> list:
    d = os.path.join(out, mesh_tag)
    rows = []
    if not os.path.isdir(d):
        return rows
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                rows.append(json.load(fh))
    rows.sort(key=lambda r: (r["arch"], _ORDER.get(r["shape"], 9)))
    return rows


_HEADER = ("| arch | shape | t_comp(s) | t_mem(s) | t_coll(s) | bottleneck | useful | roofline-frac "
           "| HBM GiB/chip (peak) | args GiB | fits |\n|---|---|---|---|---|---|---|---|---|---|---|")


def _columns(r) -> list:
    mem = r["memory"].get("total_bytes", 0) / 2**30
    return [f"{r['t_compute']:.4f}", f"{r['t_memory']:.4f}", f"{r['t_collective']:.4f}", r["bottleneck"],
            f"{r['useful_flops_ratio']:.3f}", f"{r['roofline_fraction']:.4f}", f"{mem:.2f}",
            f"{r['argument_bytes'] / 2**30:.2f}", str(r["fits"])]


def markdown(rows) -> str:
    """The reference's columns (its HBM GiB/chip is the port's peak), the
    arguments' GiB and whether the peak fits the card."""
    return "\n".join([_HEADER] + [f"| {r['arch']} | {r['shape']} | " + " | ".join(_columns(r)) + " |"
                                  for r in rows])


def markdown_both(single, multi) -> str:
    """:func:`markdown`'s columns for both meshes, "single / multi" in each
    cell (a "-" where one mesh has no record)."""
    pairs = {}
    for i, rows in enumerate((single, multi)):
        for r in rows:
            pairs.setdefault((r["arch"], r["shape"]), [None, None])[i] = r
    out = [_HEADER]
    for (arch, shape), (a, b) in sorted(pairs.items(), key=lambda kv: (kv[0][0], _ORDER.get(kv[0][1], 9))):
        cols = zip(*(_columns(r) if r is not None else ["-"] * 9 for r in (a, b)))
        out.append(f"| {arch} | {shape} | " + " | ".join(x if x == y else f"{x} / {y}" for x, y in cols) + " |")
    return "\n".join(out)


def emit_csv(rows, mesh_tag: str) -> None:
    for r in rows:
        t_total = max(r["t_compute"], r["t_memory"], r["t_collective"])
        print(
            f"roofline/{mesh_tag}/{r['arch']}/{r['shape']},{t_total*1e6:.0f},"
            f"bottleneck={r['bottleneck']};frac={r['roofline_fraction']:.4f};"
            f"useful={r['useful_flops_ratio']:.3f};fits={r['fits']}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single_pod_16x16", help="a mesh tag, or both")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR, help="the dry-run's results directory")
    args = ap.parse_args(argv)
    if args.mesh == "both":
        single, multi = load("single_pod_16x16", args.out), load("multi_pod_2x16x16", args.out)
        if args.markdown:
            print(markdown_both(single, multi))
        else:
            emit_csv(single, "single_pod_16x16")
            emit_csv(multi, "multi_pod_2x16x16")
        return
    rows = load(args.mesh, args.out)
    if args.markdown:
        print(markdown(rows))
    else:
        emit_csv(rows, args.mesh)


if __name__ == "__main__":
    main()
