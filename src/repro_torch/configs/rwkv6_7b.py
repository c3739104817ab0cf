"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— "Finch", data-dependent decay.  [arXiv:2404.05892]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # head_dim 64 WKV heads
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rope_theta=None,  # attention-free
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2404.05892",
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced",
    family="rwkv",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=896,
    vocab=512,
    rope_theta=None,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
