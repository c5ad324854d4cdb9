"""deepseek-v2-236b — MoE with multi-head latent attention (MLA).

60L d5120 128H, MLA kv_lora=512 q_lora=1536 (nope 128 / rope 64 / v 128),
2 shared + 160 routed experts top-6, expert d_ff=1536, first layer dense
(d_ff 12288), vocab=102400.  [arXiv:2405.04434]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: all heads share one latent — no GQA reduction
    head_dim=128,
    vocab=102400,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    dense_d_ff=12288,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    optimizer="adafactor",
    accum_steps=8,  # microbatch the 256-seq global batch: activations /8
)

REDUCED = ArchConfig(
    name="deepseek-v2-236b-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    vocab=256,
    n_experts=8,
    n_shared_experts=1,
    top_k=2,
    moe_d_ff=32,
    first_dense_layers=1,
    dense_d_ff=128,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
)
