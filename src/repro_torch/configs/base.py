"""Architecture configuration (a copy of ``repro/configs/base.py``).

Every architecture is an :class:`ArchConfig`: a plain frozen dataclass, so
configs are hashable and trivially serializable.  The port keeps its own
copy rather than importing the reference's, so it never imports ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "pad_to_multiple"]


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Superset config covering dense / moe / vlm / hybrid / audio / ssm families."""

    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    vocab: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA (h2o-danube)
    rope_theta: float = 500_000.0

    # --- FFN ---
    d_ff: int = 0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256  # SSD chunk length
    attn_every: int = 0  # zamba2: shared attention block every N mamba blocks

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # kernel backend policy, consumed by repro_torch.runtime.dispatch:
    #   auto      — the hand-written CUDA kernel on a CUDA tensor, the plain
    #               PyTorch version on a CPU tensor
    #   reference — the plain PyTorch version everywhere
    kernels: str = "auto"

    def __post_init__(self):
        if self.kernels not in ("auto", "reference"):
            raise ValueError(f"kernels={self.kernels!r} not in auto|reference")

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (kept from the reference so the
        two packages' parameter trees have identical shapes)."""
        return pad_to_multiple(self.vocab, 256)

    def param_count(self) -> int:
        """Analytic parameter count N."""
        from repro_torch.models.model import analytic_param_count

        return analytic_param_count(self)
