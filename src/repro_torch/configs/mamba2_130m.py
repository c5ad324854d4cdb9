"""mamba2-130m — attention-free SSM with SSD (state-space duality).

24L d768, d_inner 1536 (expand 2, head_dim 64 -> 24 ssm heads),
ssm_state=128, vocab=50280 (padded to 50432).  [arXiv:2405.21060; unverified]
A copy of the reference's ``repro/configs/mamba2_130m.py``.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    tie_embeddings=True,
)
