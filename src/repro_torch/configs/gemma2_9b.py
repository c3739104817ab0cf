"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
— local(4096-SWA)+global alternating, attn/final logit softcap, sandwich
norms, scaled tied embeddings.  [arXiv:2408.00118]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    sliding_window=4096,
    local_global_pattern=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    act="gelu",
    dtype=torch.bfloat16,
    source="arXiv:2408.00118",
)

REDUCED = ModelConfig(
    name="gemma2-9b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab=512,
    sliding_window=64,
    local_global_pattern=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    act="gelu",
    dtype=torch.float32,
    source=CONFIG.source,
)
