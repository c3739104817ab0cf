"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + weight-shared attention blocks
[arXiv:2411.15242]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="mamba_hybrid",
    n_layers=54,  # Mamba2 blocks
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,  # shared block MLP width
    vocab=32000,
    d_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,  # one weight-shared attn+MLP block per 6 Mamba blocks
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2411.15242",
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="mamba_hybrid",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    d_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=1,
    dtype=torch.float32,
    source=CONFIG.source,
)
