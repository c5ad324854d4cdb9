"""Production meshes and the card's roofline constants.

The port's counterpart of ``repro/launch/mesh.py``.  The meshes are
descriptions (:class:`~repro_torch.runtime.distributed.MeshSpec`), so that
importing or calling this touches no device and no process group; a run
makes a live mesh of the same shape with ``runtime.distributed.init``.
"""

from __future__ import annotations

from repro_torch.runtime.distributed import MeshSpec

__all__ = ["make_production_mesh", "make_rules", "HW"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """One pod: 16 x 16 = 256 ranks ("data", "model").  Two pods: 512
    ("pod", "data", "model"); the pod axis is data parallel by default, or
    pipeline stages (``train/pipeline_parallel.py``)."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_rules(mesh, *, sequence_parallel: bool = True):
    """The production rules: the sequence over "model" between blocks
    (``sequence_parallel``)."""
    from repro_torch.sharding.rules import MeshRules

    rules = MeshRules(mesh)
    if sequence_parallel:
        rules.logical["seq"] = ("model",)
    return rules


class HW:
    """One NVIDIA H100 SXM (as ``nvidia-smi`` names it: NVIDIA H100 80GB
    HBM3, at its 700 W limit), from NVIDIA's data sheet."""

    NAME = "NVIDIA H100 80GB HBM3, 700 W"
    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
    HBM_BW = 3.35e12  # B/s
    HBM_PER_CHIP = 80 * 10**9  # bytes
    # NVLink 4: 18 links of 25 GB/s each way, 450 GB/s each way in all
    NVLINK_LINK_BW = 25e9  # B/s per link and direction
    NVLINK_LINKS = 18
    # a DGX H100 node: 8 cards joined by NVLink through NVSwitch (NVIDIA's DGX H100 data sheet)
    CARDS_PER_NODE = 8
    # between nodes each card has its own ConnectX-7 port at 400 Gb/s (the same data sheet)
    NETWORK_BW_PER_CARD = 50e9  # B/s per card and direction
