"""qwen2-72b — dense, 80L d8192 64H (GQA kv=8, head_dim 128), QKV bias.

d_ff=29568 vocab=152064.  [arXiv:2407.10671]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    optimizer="adafactor",
    accum_steps=4,  # microbatch the 256-seq global batch: activations /4
)

REDUCED = ArchConfig(
    name="qwen2-72b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab=256,
    qkv_bias=True,
)
