"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — the InternViT vision encoder is a stub (256 precomputed
patch embeddings through ``prefix_proj``, prepended to the text); this is
the InternLM2-20B language backbone, untied head.  [arXiv:2404.16821]"""

import torch

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    prefix_len=256,  # stub ViT patch embeddings prepended to text
    rope_theta=1000000.0,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    source="arXiv:2404.16821",
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab=512,
    prefix_len=16,
    rope_theta=1000000.0,
    tie_embeddings=False,
    dtype=torch.float32,
    source=CONFIG.source,
)
