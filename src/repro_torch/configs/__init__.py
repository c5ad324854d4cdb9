"""Architecture configs (copies of the reference's jax-free config modules)."""

from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import get_arch  # noqa: F401
