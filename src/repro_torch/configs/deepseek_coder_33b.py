"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-architecture, untied head.  [arXiv:2401.14196]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    rope_theta=100000.0,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2401.14196",
)

REDUCED = ModelConfig(
    name="deepseek-coder-33b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=640,
    vocab=512,
    rope_theta=100000.0,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
