"""Dense decoder-only transformer (``repro.models.transformer``, family
``"dense"``): config, parameter layout, init, forward and loss.

Parameters are a flat ``{name: tensor}`` dict whose names and order are the
reference's ``jax.tree_util.tree_flatten_with_path`` of ``init_params``
(``checkpoint._flatten_with_names`` naming, e.g. ``blocks/attn/wq``).  That
order defines the packed client workspace (``dist/comm_ws.py``) and with it
which client owns which coordinate, so it must not change.  Every
``blocks/*`` leaf is stacked ``(n_layers, ...)`` for the same reason.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``repro.models.transformer.ModelConfig`` that the
    dense path reads.  Parameters are always stored in f32 (the client
    workspace is f32); ``dtype`` is the compute dtype."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: Optional[float] = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window of the "local" layers
    local_global_pattern: Optional[int] = None  # 2 -> every 2nd layer local
    sliding_window_override: Optional[int] = None  # force SWA on all layers
    post_norm: bool = False  # gemma2 sandwich norms
    act: str = "silu"
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma multiplies embed by sqrt(d_model)
    dtype: torch.dtype = torch.bfloat16
    xent_chunk: int = 512
    source: str = ""

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(
                f"family {self.family!r} is not ported; only 'dense' is")
        if not self.tie_embeddings:
            raise ValueError("untied embeddings (lm_head) are not ported")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128 (logits past the
        logical vocab are masked in the loss)."""
        return -(-self.vocab // 128) * 128

    def layer_windows(self) -> List[int]:
        """Per-layer sliding windows; 0 means global."""
        if self.sliding_window_override is not None:
            return [self.sliding_window_override] * self.n_layers
        if self.sliding_window and self.local_global_pattern:
            return [
                self.sliding_window if i % self.local_global_pattern == 0
                else 0
                for i in range(self.n_layers)
            ]
        if self.sliding_window:
            return [self.sliding_window] * self.n_layers
        return [0] * self.n_layers


def param_specs(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """``[(name, shape)]`` of every parameter leaf, in the reference's
    ``jax.tree.leaves`` order (dict keys sorted at every level)."""
    L, d, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    norms = ["ln_attn", "ln_attn_post", "ln_ff", "ln_ff_post"] \
        if cfg.post_norm else ["ln_attn", "ln_ff"]
    return [
        ("blocks/attn/wk", (L, d, kv)),
        ("blocks/attn/wo", (L, q, d)),
        ("blocks/attn/wq", (L, d, q)),
        ("blocks/attn/wv", (L, d, kv)),
        *[(f"blocks/{nm}/scale", (L, d)) for nm in norms],
        ("blocks/mlp/w_down", (L, F, d)),
        ("blocks/mlp/w_gate", (L, d, F)),
        ("blocks/mlp/w_up", (L, d, F)),
        ("embed", (cfg.padded_vocab, d)),
        ("final_norm/scale", (d,)),
    ]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Random f32 parameters with the reference's init scales: matrices
    ``N(0, 1/in_dim)``, the embedding ``N(0, 0.02^2)``, norm scales ones.
    ``generator`` must live on ``device``; the draws are the port's own
    (a reference init is carried over with ``repro_torch.convert``)."""
    dev = resolve_device(device)
    params: Params = {}
    for name, shape in param_specs(cfg):
        if name.endswith("/scale"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        scale = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
        params[name] = w.mul_(scale)
    return params


def _block(p: Params, l: int, x: torch.Tensor, cfg: ModelConfig,
           window: int) -> torch.Tensor:
    t = x.shape[1]
    # 0 -> global: a window longer than the sequence masks nothing
    eff_window = window if window > 0 else t + 1
    h = layers.rmsnorm(p["blocks/ln_attn/scale"][l], x)
    h = layers.attention(
        h, p["blocks/attn/wq"][l], p["blocks/attn/wk"][l],
        p["blocks/attn/wv"][l], p["blocks/attn/wo"][l],
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        window=eff_window, attn_softcap=cfg.attn_softcap,
    )
    if cfg.post_norm:
        h = layers.rmsnorm(p["blocks/ln_attn_post/scale"][l], h)
    x = x + h
    h = layers.rmsnorm(p["blocks/ln_ff/scale"][l], x)
    h = layers.mlp(h, p["blocks/mlp/w_gate"][l], p["blocks/mlp/w_up"][l],
                   p["blocks/mlp/w_down"][l], cfg.act)
    if cfg.post_norm:
        h = layers.rmsnorm(p["blocks/ln_ff_post/scale"][l], h)
    return x + h


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """``tokens (b, t)`` -> final hidden states ``(b, t, d_model)``."""
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.scale_embed:
        # sqrt(d_model) rounded to the compute dtype, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(cfg.dtype)
    for l, w in enumerate(cfg.layer_windows()):
        x = _block(params, l, x, cfg, w)
    return layers.rmsnorm(params["final_norm/scale"], x)


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy; the tied embedding is the head."""
    h = forward(params, cfg, tokens)
    xent = layers.chunked_softmax_xent(
        h, params["embed"].T, labels, chunk=cfg.xent_chunk,
        logit_softcap=cfg.final_softcap, valid_vocab=cfg.vocab,
    )
    return xent, {"xent": xent}
