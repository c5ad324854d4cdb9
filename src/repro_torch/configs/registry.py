"""Architecture registry: ``--arch <id>`` resolution and the dry-run's cells.

The port resolves every architecture the reference registry knows, and
walks the (arch x shape) cells in the reference's order.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_CELLS, ArchConfig, ShapeCell

_ARCH_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

# every arch the reference registry resolves (repro/configs/registry.py)
REFERENCE_ARCH_IDS = (
    "llama3.2-1b",
    "h2o-danube-1.8b",
    "qwen2-72b",
    "minitron-4b",
    "deepseek-v2-236b",
    "phi3.5-moe-42b-a6.6b",
    "llama-3.2-vision-11b",
    "zamba2-1.2b",
    "whisper-small",
    "mamba2-130m",
)

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str, *, reduced: bool = False) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REFERENCE_ARCH_IDS)}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.REDUCED if reduced else mod.CONFIG

# Cells that require sub-quadratic / bounded-window decode memory.  Pure
# full-attention archs skip long_500k (the reference's skip table).
LONG_CONTEXT_ARCHS = {"mamba2-130m", "zamba2-1.2b", "h2o-danube-1.8b"}


def get_shape(name: str) -> ShapeCell:
    return SHAPE_CELLS[name]


def cell_is_runnable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return False, "full-attention arch: 500k-token KV decode is out of regime (DESIGN.md §6)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) cell, in the reference registry's order."""
    out = []
    for a in REFERENCE_ARCH_IDS:
        for s in SHAPE_CELLS:
            ok, _ = cell_is_runnable(a, s)
            if ok:
                out.append((a, s))
    return out
