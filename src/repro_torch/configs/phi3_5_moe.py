"""phi3.5-moe-42b-a6.6b — MoE, 32L d4096 32H (GQA kv=8, head_dim 128).

16 experts top-2, expert d_ff=6400, vocab=32064, untied lm_head.
[hf:microsoft/Phi-3.5-MoE-instruct]  A copy of the reference's
``repro/configs/phi3_5_moe.py``.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    vocab=32064,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=10_000.0,
)

REDUCED = ArchConfig(
    name="phi3.5-moe-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    vocab=256,
    n_experts=4,
    top_k=2,
    moe_d_ff=48,
)
