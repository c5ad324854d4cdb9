"""Roofline terms of a dry-run cell, priced at one card's data-sheet figures.

The port's counterpart of ``repro/roofline/analysis.py``.  Three terms per
(arch x shape x mesh) cell, in seconds, per rank:

    t_compute    = FLOPs       / peak_flops   (HW.PEAK_FLOPS_BF16)
    t_memory     = HBM bytes   / hbm_bw       (HW.HBM_BW)
    t_collective = sum over mesh axes of the axis's bytes / its rate

An axis whose every group of ranks lies within one node of
``HW.CARDS_PER_NODE`` cards runs at NVLink's rate (``HW.NVLINK_LINK_BW *
HW.NVLINK_LINKS``); any other at the node network's rate a card
(``HW.NETWORK_BW_PER_CARD``).  Ranks lie on a mesh row-major, as
``runtime/distributed.py::MeshSpec`` lays them out.  Every rate is a data
sheet's (``launch/mesh.py::HW`` names each source); none is a measurement.
The counts come from ``roofline/op_stats.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Union

from repro_torch.launch.mesh import HW

__all__ = ["CollectiveStats", "Roofline", "roofline_terms", "axis_bandwidth", "NVLINK_BW"]

NVLINK_BW = HW.NVLINK_LINK_BW * HW.NVLINK_LINKS  # B/s each way, one card's NVLink in all


@dataclasses.dataclass
class CollectiveStats:
    """Per-rank collective traffic (ring-transfer bytes) by op kind and by mesh axis."""

    by_kind: dict
    op_count: int
    by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float  # per-rank FLOPs
    hbm_bytes: float  # per-rank bytes accessed
    coll_bytes: float  # per-rank collective bytes moved
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_global: float  # 6*N*D analytic
    chips: int
    peak_flops: float = HW.PEAK_FLOPS_BF16

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs) — remat/redundancy waste."""
        global_flops = self.flops * self.chips
        return self.model_flops_global / global_flops if global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the bounding term == achievable MFU,
        against the ``peak_flops`` the terms were priced at."""
        if self.t_total <= 0:
            return 0.0
        return (self.model_flops_global / self.chips) / (self.t_total * self.peak_flops)


def axis_bandwidth(mesh, axis: str) -> float:
    """The rate of one collective along ``axis`` of ``mesh`` (a MeshSpec, or
    anything with ``axes`` and ``sizes``), a card and direction: NVLink's
    where every group along the axis lies within one node, else the
    network's.  ``axis`` may name several axes joined by commas (a group
    over their product)."""
    names = axis.split(",")
    sizes = dict(zip(mesh.axes, mesh.sizes))
    others = [a for a in mesh.axes if a not in names]
    for fixed in itertools.product(*(range(sizes[a]) for a in others)):
        coords = dict(zip(others, fixed))
        nodes = set()
        for along in itertools.product(*(range(sizes[a]) for a in names)):
            coords.update(zip(names, along))
            r = 0
            for a in mesh.axes:
                r = r * sizes[a] + coords[a]
            nodes.add(r // HW.CARDS_PER_NODE)
        if len(nodes) > 1:
            return HW.NETWORK_BW_PER_CARD
    return NVLINK_BW


def roofline_terms(
    *,
    flops: float,
    hbm_bytes: float,
    coll_bytes: Union[float, Dict[str, float]],
    chips: int,
    model_flops_global: float,
    peak_flops: float = HW.PEAK_FLOPS_BF16,
    hbm_bw: float = HW.HBM_BW,
    ici_bw: Union[float, Dict[str, float]] = NVLINK_BW,
) -> Roofline:
    """``coll_bytes`` a total priced at ``ici_bw`` (the reference's form), or
    {axis: bytes} with ``ici_bw`` {axis: rate} (:func:`axis_bandwidth`)."""
    if isinstance(coll_bytes, dict):
        t_coll = sum(b / ici_bw[a] for a, b in coll_bytes.items())
        total = sum(coll_bytes.values())
    else:
        t_coll, total = coll_bytes / ici_bw, coll_bytes
    return Roofline(
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_bytes=total,
        t_compute=flops / peak_flops,
        t_memory=hbm_bytes / hbm_bw,
        t_collective=t_coll,
        model_flops_global=model_flops_global,
        chips=chips,
        peak_flops=peak_flops,
    )
