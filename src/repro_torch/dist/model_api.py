"""Model API of the port (``repro.dist.model_api``) over the dense, MoE,
RWKV, Mamba2-hybrid and encoder-decoder families: ``init`` and ``loss``
for training, ``prefill``, ``make_cache`` and ``decode`` for serving, plus
the parameter layout the workspace packs."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import encdec, layers
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
         labels: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
         frames: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(scalar loss, metrics)`` of one client's batch: the total loss
    (the cross-entropy plus the MoE load-balance term, which the local
    step differentiates) and ``{"xent", "moe_aux"}`` (``{"xent"}`` for the
    encoder-decoder); ``prefix_embeds (b, P, d_model)`` go before the
    tokens and the loss is on the text positions only; ``frames (b,
    n_frames, d_model)`` are the encoder-decoder's input, which needs them
    and takes no prefix (the reference's ``ValueError``s)."""
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec loss requires frames")
        if prefix_embeds is not None:
            raise ValueError("encdec does not consume prefix_embeds")
        return encdec.loss_fn(params, cfg, frames, tokens, labels)
    if frames is not None:
        raise ValueError(f"family {cfg.family!r} does not consume frames")
    return tr.loss_fn(params, cfg, tokens, labels, prefix_embeds)


def prefill(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (``prefix_embeds`` before the tokens; for the
    encoder-decoder the decoder against ``encode(frames)``); the last
    position's logits ``(b, vocab)``, the hidden state and the head in
    f32 (the decode loop's cache is built by stepping ``decode``, which
    takes no prefix)."""
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec prefill requires frames")
        h = encdec.decode_train(params, cfg, tokens,
                                encdec.encode(params, cfg, frames))
    else:
        if frames is not None:
            raise ValueError(f"family {cfg.family!r} does not consume "
                             "frames")
        h = tr.forward(params, cfg, tokens, prefix_embeds)
    logits = torch.matmul(h[:, -1].float(),
                          tr.lm_head_weight(params, cfg).float())
    return layers.softcap(logits[:, :cfg.vocab], cfg.final_softcap)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Params:
    """The decode cache (zeros) on ``device``: the family's
    (``transformer.init_cache``; the encoder-decoder's
    ``encdec.init_cache`` with ``cfg.n_frames`` cross rows, which
    ``encdec.precompute_cross_kv`` fills)."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_seq, cfg.n_frames,
                                 kv_dtype, device)
    return tr.init_cache(cfg, batch, max_seq, kv_dtype, device)


def decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
           cache: Params, pos: int, attend_fn: Optional[tr.AttendFn] = None
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step (``transformer.decode_step``; the encoder-decoder's
    ``encdec.decode_step``, which takes no ``attend_fn``, as the
    reference's); the cache is updated in place and returned."""
    if cfg.family == "encdec":
        return encdec.decode_step(params, cfg, token, cache, pos)
    return tr.decode_step(params, cfg, token, cache, pos,
                          attend_fn=attend_fn)
