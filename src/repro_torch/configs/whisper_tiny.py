"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865
— encoder-decoder; the mel-spectrogram and convolution frontend is a stub
(frame embeddings, 1500 frames).  [arXiv:2212.04356]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    n_encoder_layers=4,
    n_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    rope_theta=None,  # sinusoidal positions
    tie_embeddings=True,
    act="gelu",
    dtype=torch.bfloat16,
    source="arXiv:2212.04356",
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    n_frames=64,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    rope_theta=None,
    tie_embeddings=True,
    act="gelu",
    dtype=torch.float32,
    source=CONFIG.source,
)
