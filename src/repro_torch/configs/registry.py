"""Architecture registry of the port: every architecture of the
reference's registry (dense, MoE, RWKV, Mamba2-hybrid and
encoder-decoder)."""

from __future__ import annotations

import importlib

from repro_torch.models.transformer import ModelConfig

ARCHS = {
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}


def list_archs():
    return sorted(ARCHS)


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    """Full-size config at the published widths."""
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """The small smoke config the CPU tests use."""
    return _module(arch).REDUCED
