"""whisper-small — encoder-decoder, 12L enc + 12L dec, d768 12H d_ff=3072.

vocab=51865 (padded to 51968).  The conv audio frontend is a stub: each
request carries its own ``frames`` of (n_audio_frames = 1500, d_model)
precomputed frame embeddings.  [arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    n_audio_frames=1500,
    rope_theta=10_000.0,  # the decode steps' rotary embedding (the reference's; the prompt has none)
)

REDUCED = ArchConfig(
    name="whisper-small-reduced",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_audio_frames=32,
)
