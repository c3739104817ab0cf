"""Model API of the port (``repro.dist.model_api``): ``init`` and ``loss``
over the dense family, plus the parameter layout the workspace packs."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import ModelConfig

Params = Dict[str, torch.Tensor]

__all__ = ["init", "loss", "param_specs"]


def param_specs(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """``[(name, shape)]`` of every parameter, in the reference's leaf
    order."""
    return tr.param_specs(cfg)


def init(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random f32 parameters drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tr.init_params(cfg, gen, dev)


def loss(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
         labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(scalar loss, metrics)`` of one client's batch."""
    return tr.loss_fn(params, cfg, tokens, labels)
