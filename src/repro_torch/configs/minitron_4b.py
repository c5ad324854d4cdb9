"""minitron-4b — pruned nemotron, dense, 32L d3072 24H (GQA kv=8, head_dim 128).

d_ff=9216 vocab=256000.  [arXiv:2407.14679]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    rope_theta=10_000.0,
)

REDUCED = ArchConfig(
    name="minitron-4b-reduced",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    head_dim=16,
    d_ff=144,
    vocab=512,
)
