"""Architecture registry of the port (dense family only)."""

from __future__ import annotations

import importlib

from repro_torch.models.transformer import ModelConfig

ARCHS = {
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
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
