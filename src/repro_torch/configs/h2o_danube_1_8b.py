"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window attention.

24L d2560 32H (GQA kv=8, head_dim 80) d_ff=6912 vocab=32000, window 4096.
[arXiv:2401.16818]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)

REDUCED = ArchConfig(
    name="h2o-danube-1.8b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    sliding_window=32,
)
