"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768 vocab=151936, MoE 128 experts top-8 (no shared experts,
renormalized top-k).  [hf:Qwen/Qwen3-30B-A3B]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    num_experts=128,
    top_k=8,
    shared_d_ff=0,
    renormalize=True,
    vocab=151936,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-30B-A3B",
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=128,
    moe_d_ff=128,
    num_experts=4,
    top_k=2,
    shared_d_ff=0,
    renormalize=True,
    vocab=512,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
