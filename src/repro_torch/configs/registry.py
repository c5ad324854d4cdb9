"""Architecture registry: ``--arch <id>`` resolution for the ported archs.

The reference registry knows ten architectures; the port resolves only the
ones whose model family it carries so far and says so for the rest.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
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
        if arch_id in REFERENCE_ARCH_IDS:
            raise NotImplementedError(
                f"arch {arch_id!r} is not yet ported to repro_torch "
                f"(ported: {sorted(_ARCH_MODULES)})"
            )
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REFERENCE_ARCH_IDS)}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.REDUCED if reduced else mod.CONFIG
