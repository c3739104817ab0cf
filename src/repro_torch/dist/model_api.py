"""Model API of the port (``repro.dist.model_api``) over the dense, MoE,
RWKV and Mamba2-hybrid families: ``init`` and ``loss`` for training,
``prefill``, ``make_cache`` and ``decode`` for serving, plus the parameter
layout the workspace packs."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import ModelConfig

Params = Dict[str, torch.Tensor]

__all__ = ["init", "loss", "param_specs", "prefill", "make_cache",
           "decode"]


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
         labels: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(scalar loss, metrics)`` of one client's batch: the total loss
    (the cross-entropy plus the MoE load-balance term, which the local
    step differentiates) and ``{"xent", "moe_aux"}``; ``prefix_embeds
    (b, P, d_model)`` go before the tokens and the loss is on the text
    positions only."""
    return tr.loss_fn(params, cfg, tokens, labels, prefix_embeds)


def prefill(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (``prefix_embeds`` before the tokens); the
    last position's logits ``(b, vocab)``, the hidden state and the head in
    f32 (the decode loop's cache is built by stepping ``decode``, which
    takes no prefix)."""
    h = tr.forward(params, cfg, tokens, prefix_embeds)
    logits = torch.matmul(h[:, -1].float(),
                          tr.lm_head_weight(params, cfg).float())
    return layers.softcap(logits[:, :cfg.vocab], cfg.final_softcap)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Params:
    """The decode cache (zeros) on ``device``: the family's
    (``transformer.init_cache``)."""
    return tr.init_cache(cfg, batch, max_seq, kv_dtype, device)


def decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
           cache: Params, pos: int, attend_fn: Optional[tr.AttendFn] = None
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step (``transformer.decode_step``); the cache is
    updated in place and returned."""
    return tr.decode_step(params, cfg, token, cache, pos,
                          attend_fn=attend_fn)
