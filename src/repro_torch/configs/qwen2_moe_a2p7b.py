"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4 + 4 shared experts (fused 4*1408 shared
MLP with sigmoid gate).  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # informational: per-expert width
    moe_d_ff=1408,
    num_experts=60,
    top_k=4,
    shared_d_ff=5632,  # 4 shared experts fused: 4 * 1408
    renormalize=False,  # Qwen1.5-MoE: norm_topk_prob = false
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    moe_d_ff=128,
    num_experts=4,
    top_k=2,
    shared_d_ff=256,
    renormalize=False,
    vocab=512,
    qkv_bias=True,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
