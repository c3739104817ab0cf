"""Dense decoder-only transformer (``repro.models.transformer``, family
``"dense"``): config, parameter layout, init, forward and loss, and the
decode side: the KV cache and one decode step against it.

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
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]

# the window a global layer decodes with (the reference's
# ``jnp.iinfo(jnp.int32).max // 2``): wider than any cache
GLOBAL_WINDOW = (2 ** 31 - 1) // 2


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
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window of the "local" layers
    local_global_pattern: Optional[int] = None  # 2 -> every 2nd layer local
    sliding_window_override: Optional[int] = None  # force SWA on all layers
    post_norm: bool = False  # gemma2 sandwich norms
    act: str = "silu"
    tie_embeddings: bool = True
    prefix_len: int = 0  # stub frontend: embeddings prepended to the text
    scale_embed: bool = False  # gemma multiplies embed by sqrt(d_model)
    dtype: torch.dtype = torch.bfloat16
    xent_chunk: int = 512
    source: str = ""

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(
                f"family {self.family!r} is not ported; only 'dense' is")

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
    ``jax.tree.leaves`` order (dict keys sorted at every level): the
    biases before the attention matrices, and ``lm_head`` and
    ``prefix_proj`` after ``final_norm`` where the config has them."""
    L, d, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    norms = ["ln_attn", "ln_attn_post", "ln_ff", "ln_ff_post"] \
        if cfg.post_norm else ["ln_attn", "ln_ff"]
    biases = [("blocks/attn/bk", (L, kv)), ("blocks/attn/bq", (L, q)),
              ("blocks/attn/bv", (L, kv))] if cfg.qkv_bias else []
    return [
        *biases,
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
        *([] if cfg.tie_embeddings
          else [("lm_head", (d, cfg.padded_vocab))]),
        *([("prefix_proj", (d, d))] if cfg.prefix_len else []),
    ]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Random f32 parameters with the reference's init scales: matrices
    (``lm_head`` and ``prefix_proj`` included) ``N(0, 1/in_dim)``, the
    embedding ``N(0, 0.02^2)``, norm scales ones, q/k/v biases zeros.
    ``generator`` must live on ``device``; the draws are the port's own
    (a reference init is carried over with ``repro_torch.convert``)."""
    dev = resolve_device(device)
    params: Params = {}
    for name, shape in param_specs(cfg):
        if name.endswith("/scale"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        if name.startswith("blocks/attn/b"):
            params[name] = torch.zeros(shape, dtype=torch.float32,
                                       device=dev)
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
        biases=_biases(p, l, cfg),
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


def _biases(p: Params, l: int, cfg: ModelConfig
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Layer ``l``'s ``(bq, bk, bv)``, or ``None`` without biases."""
    if not cfg.qkv_bias:
        return None
    return tuple(p[f"blocks/attn/{nm}"][l] for nm in ("bq", "bk", "bv"))


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings in the compute dtype, scaled by sqrt(d_model)
    (rounded to the compute dtype, as the reference does) for gemma."""
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(cfg.dtype)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tokens (b, t)`` -> final hidden states ``(b, P + t, d_model)``.
    ``prefix_embeds (b, P, d_model)`` (a stub frontend's patch
    embeddings), in the compute dtype and through ``prefix_proj`` where
    the model has it, go before the token embeddings."""
    x = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.dtype)
        if "prefix_proj" in params:
            pe = layers.matmul(pe, params["prefix_proj"])
        x = torch.cat([pe, x], dim=1)
    for l, w in enumerate(cfg.layer_windows()):
        x = _block(params, l, x, cfg, w)
    return layers.rmsnorm(params["final_norm/scale"], x)


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the text positions (the prefix's
    are dropped) through ``lm_head_weight``."""
    h = forward(params, cfg, tokens, prefix_embeds)
    if prefix_embeds is not None:
        h = h[:, prefix_embeds.shape[1]:]
    xent = layers.chunked_softmax_xent(
        h, lm_head_weight(params, cfg), labels, chunk=cfg.xent_chunk,
        logit_softcap=cfg.final_softcap, valid_vocab=cfg.vocab,
    )
    return xent, {"xent": xent}


def lm_head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The vocab projection ``(d_model, padded_vocab)``: the tied
    embedding, transposed (a view), or the untied ``lm_head``."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# --------------------------------------------------------------------------
# decode (one new token against a cache)
# --------------------------------------------------------------------------

AttendFn = Callable[..., torch.Tensor]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Params:
    """The KV cache ``{"k", "v"}``, each ``(n_layers, batch, max_seq,
    n_kv_heads, head_dim)`` zeros of ``kv_dtype``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: int,
                attend_fn: Optional[AttendFn] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``token (b, 1)`` at position ``pos`` -> ``(logits
    (b, vocab) f32, cache)``.  Each layer writes its K/V row at ``pos``
    into ``cache`` in place (the reference returns an updated copy) and
    attends with ``attend_fn(q, cache_k, cache_v, pos, window)`` or, when
    it is ``None``, the plain ``_decode_scores_dyn``.  Global layers use
    the window ``GLOBAL_WINDOW``.  Raises on ``pos`` outside the cache,
    where the reference's ``dynamic_update_slice`` clamps to the last
    row."""
    pos = int(pos)
    max_seq = cache["k"].shape[2]
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside the cache's {max_seq} rows")
    x = _embed(params, cfg, token)
    for l, w in enumerate(cfg.layer_windows()):
        window = w if w > 0 else GLOBAL_WINDOW
        h = layers.rmsnorm(params["blocks/ln_attn/scale"][l], x)
        h = _attention_decode_dyn(params, l, h, cache, pos, cfg, window,
                                  attend_fn)
        if cfg.post_norm:
            h = layers.rmsnorm(params["blocks/ln_attn_post/scale"][l], h)
        x = x + h
        h = layers.rmsnorm(params["blocks/ln_ff/scale"][l], x)
        h = layers.mlp(h, params["blocks/mlp/w_gate"][l],
                       params["blocks/mlp/w_up"][l],
                       params["blocks/mlp/w_down"][l], cfg.act)
        if cfg.post_norm:
            h = layers.rmsnorm(params["blocks/ln_ff_post/scale"][l], h)
        x = x + h
    h = layers.rmsnorm(params["final_norm/scale"], x)[:, 0]
    logits = layers.wide_matmul(h, lm_head_weight(params, cfg))
    return layers.softcap(logits[:, :cfg.vocab], cfg.final_softcap), cache


def _attention_decode_dyn(p: Params, l: int, x: torch.Tensor, cache: Params,
                          pos: int, cfg: ModelConfig, window: int,
                          attend_fn: Optional[AttendFn]) -> torch.Tensor:
    """Layer ``l``'s attention for one position: q/k/v, RoPE at ``pos``,
    the K/V row written at ``pos`` (in the cache's dtype), attention over
    the cache, the output projection."""
    b = x.shape[0]
    q, k, v = layers.qkv(x, p["blocks/attn/wq"][l], p["blocks/attn/wk"][l],
                         p["blocks/attn/wv"][l], cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, _biases(p, l, cfg))
    if cfg.rope_theta is not None:
        q = layers.rope_at(q, pos, cfg.rope_theta)
        k = layers.rope_at(k, pos, cfg.rope_theta)
    cache_k, cache_v = cache["k"][l], cache["v"][l]
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    if attend_fn is not None:
        out = attend_fn(q, cache_k, cache_v, pos, window)
    else:
        out = _decode_scores_dyn(q, cache_k, cache_v, pos, window, cfg)
    return layers.matmul(out.reshape(b, 1, cfg.n_heads * cfg.head_dim_),
                         p["blocks/attn/wo"][l])


def _decode_scores_dyn(q: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, pos: int, window: int,
                       cfg: ModelConfig) -> torch.Tensor:
    """The plain decode attention of the reference's model: the cache
    converted to ``q``'s dtype, f32 logits and softmax, keys ``pos -
    window < t <= pos``, the probabilities rounded to ``q``'s dtype before
    the weighted sum (``(b, 1, h, hd)``)."""
    b, _, h, hd = q.shape
    S, kvh = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    logits = torch.einsum(
        "btkgd,bskd->bkgts", layers.widen(qg),
        layers.widen(cache_k.to(q.dtype))) / math.sqrt(hd)
    logits = layers.softcap(logits, cfg.attn_softcap)
    kpos = torch.arange(S, device=q.device)
    mask = (kpos <= pos) & (kpos > pos - window)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, cache_v.to(q.dtype))
    return out.reshape(b, 1, h, hd)
