"""zamba2-1.2b — hybrid: Mamba2 backbone + SHARED attention block.

38 mamba2 layers d2048 (d_inner 4096, ssm_state 64, head_dim 64), one shared
attention+MLP block (32H MHA, d_ff 8192) applied every 6 mamba layers with
tied weights across applications.  vocab=32000.  [arXiv:2411.15242]
A copy of the reference's ``repro/configs/zamba2_1_2b.py``.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
)

REDUCED = ArchConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_every=2,
)
