"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 — q/k/v biases, untied head, head_dim 80.
[hf:stabilityai/stablelm-2-1_6b]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope_theta=10000.0,
    qkv_bias=True,  # stablelm-2 uses qkv biases
    tie_embeddings=False,
    act="silu",
    dtype=torch.bfloat16,
    source="hf:stabilityai/stablelm-2-1_6b",
)

REDUCED = ModelConfig(
    name="stablelm-3b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=688,
    vocab=512,
    qkv_bias=True,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
