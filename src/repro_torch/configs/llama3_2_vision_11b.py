"""llama-3.2-vision-11b — VLM backbone: 40L d4096 32H (GQA kv=8, head_dim 128).

d_ff=14336 vocab=128256; a cross-attention image layer every 5th layer,
over ``n_image_tokens`` precomputed patch embeddings (the vision encoder is
a stub: each request carries its own ``image_embed`` of (n_image_tokens,
d_model)).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    n_image_tokens=1600,
    rope_theta=500_000.0,
)

REDUCED = ArchConfig(
    name="llama-3.2-vision-11b-reduced",
    family="vlm",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    cross_attn_every=5,
    n_image_tokens=16,
)
