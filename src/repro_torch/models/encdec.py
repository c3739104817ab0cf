"""Whisper-style encoder-decoder (``repro.models.encdec``, arXiv:2212.04356).

The audio frontend (log-mel spectrogram and its convolutions) is a stub, as
in the reference: the model takes frame embeddings ``(b, n_frames,
d_model)`` and runs the transformer that consumes them:

  encoder  bidirectional self-attention over the frames, sinusoidal
           positions, LayerNorm and an ungated GELU MLP per layer
  decoder  causal self-attention, cross-attention to the encoder's output,
           the MLP; the head is the tied embedding

Under ``cfg.remat`` each encoder and decoder layer recomputes its
activations in the backward (``transformer.layer``), as the reference
checkpoints its scanned bodies.

Parameters are a flat ``{name: tensor}`` dict in the reference's leaf
order (``param_specs``); the ``enc_blocks/*`` and ``dec_blocks/*`` leaves
are stacked ``(layers, ...)``.  Decoding keeps the self-attention's K/V
cache and the cross-attention's K/V, computed once from the encoder's
output (``precompute_cross_kv``), in one cache.  The decode step takes no
pluggable attention (the reference's takes none either).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import ModelConfig, _attn_weights, layer

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...]]]

ENC, DEC = "enc_blocks/", "dec_blocks/"


def _block_specs(pre: str, n: int, cfg: ModelConfig, cross: bool) -> Spec:
    """One stack of blocks, keys sorted as the reference's tree: ``attn <
    ln_attn < ln_ff < ln_x < mlp < xattn``, ``bk < bq < bv < wk < wo < wq
    < wv``."""
    st, d, F = (n,), cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_

    def attn(name: str) -> Spec:
        a = pre + name + "/"
        return [(a + "bk", st + (kv,)), (a + "bq", st + (q,)),
                (a + "bv", st + (kv,)), (a + "wk", st + (d, kv)),
                (a + "wo", st + (q, d)), (a + "wq", st + (d, q)),
                (a + "wv", st + (d, kv))]

    def ln(name: str) -> Spec:
        return [(pre + name + "/bias", st + (d,)),
                (pre + name + "/scale", st + (d,))]

    return [*attn("attn"), *ln("ln_attn"), *ln("ln_ff"),
            *(ln("ln_x") if cross else []),
            (pre + "mlp/w_down", st + (F, d)), (pre + "mlp/w_up", st + (d, F)),
            *(attn("xattn") if cross else [])]


def param_specs(cfg: ModelConfig) -> Spec:
    """``[(name, shape)]`` in the reference's ``jax.tree.leaves`` order:
    ``dec_blocks/*``, ``embed``, ``enc_blocks/*``, ``enc_norm/*``,
    ``final_norm/*``."""
    d = cfg.d_model
    return [*_block_specs(DEC, cfg.n_layers, cfg, True),
            ("embed", (cfg.padded_vocab, d)),
            *_block_specs(ENC, cfg.n_encoder_layers, cfg, False),
            ("enc_norm/bias", (d,)), ("enc_norm/scale", (d,)),
            ("final_norm/bias", (d,)), ("final_norm/scale", (d,))]


def _ln(p: Params, name: str, x: torch.Tensor,
        l: Optional[int] = None) -> torch.Tensor:
    """The LayerNorm ``name`` (layer ``l`` where stacked) of ``x``."""
    scale, bias = p[name + "/scale"], p[name + "/bias"]
    if l is not None:
        scale, bias = scale[l], bias[l]
    return layers.layernorm(scale, bias, x)


def _self_attention(p: Params, pre: str, l: int, x: torch.Tensor,
                    cfg: ModelConfig, causal: bool) -> torch.Tensor:
    wq, wk, wv, wo, biases = _attn_weights(p, pre, l)
    return layers.attention(
        x, wq, wk, wv, wo, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=None, window=x.shape[1] + 1,
        attn_softcap=None, biases=biases, causal=causal)


def _mlp(p: Params, pre: str, l: int, x: torch.Tensor) -> torch.Tensor:
    """The ungated GELU MLP (the reference's ``act="gelu"``, whatever
    ``cfg.act`` says)."""
    return layers.mlp(x, None, p[pre + "mlp/w_up"][l],
                      p[pre + "mlp/w_down"][l], "gelu")


def _with_positions(x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return x + layers.sinusoid(positions, cfg.d_model, cfg.dtype)[None]


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """``frames (b, T, d_model)`` (the stub frontend's output), cast to the
    compute dtype, plus the sinusoid -> the encoder's output ``(b, T,
    d_model)``."""
    x = frames.to(cfg.dtype)
    x = _with_positions(x, torch.arange(x.shape[1], device=x.device), cfg)
    for l in range(cfg.n_encoder_layers):
        x = layer(cfg, lambda x, l=l: _encoder_layer(params, l, x, cfg), x)
    return _ln(params, "enc_norm", x)


def _encoder_layer(p: Params, l: int, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Encoder layer ``l``: bidirectional self-attention, then the MLP."""
    x = x + _self_attention(p, ENC, l, _ln(p, ENC + "ln_attn", x, l), cfg,
                            causal=False)
    return x + _mlp(p, ENC, l, _ln(p, ENC + "ln_ff", x, l))


def _decoder_layer(p: Params, l: int, x: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Decoder layer ``l``: causal self-attention, cross-attention to
    ``enc_out`` (its K/V computed here), then the MLP."""
    x = x + _self_attention(p, DEC, l, _ln(p, DEC + "ln_attn", x, l), cfg,
                            causal=True)
    x = x + _cross_attend(p, l, x, *_cross_kv(p, l, enc_out, cfg), cfg)
    return x + _mlp(p, DEC, l, _ln(p, DEC + "ln_ff", x, l))


def _cross_kv(p: Params, l: int, enc: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``l``'s cross-attention keys and values of the encoder's
    output, in its dtype: ``(b, T, kv_heads, head_dim)`` each."""
    b, te, _ = enc.shape
    shape = (b, te, cfg.n_kv_heads, cfg.head_dim_)
    a = DEC + "xattn/"
    k = layers.matmul(enc, p[a + "wk"][l]) + p[a + "bk"][l].to(enc.dtype)
    v = layers.matmul(enc, p[a + "wv"][l]) + p[a + "bv"][l].to(enc.dtype)
    return k.view(shape), v.view(shape)


def _cross_attend(p: Params, l: int, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Layer ``l``'s cross-attention of ``x (b, t, d)`` to ``k, v``."""
    b, t, _ = x.shape
    a = DEC + "xattn/"
    h = _ln(p, DEC + "ln_x", x, l)
    q = layers.matmul(h, p[a + "wq"][l]) + p[a + "bq"][l].to(h.dtype)
    out = layers.attention_scores(
        q.view(b, t, cfg.n_heads, cfg.head_dim_), k, v)
    return layers.matmul(out.reshape(b, t, cfg.n_heads * cfg.head_dim_),
                         p[a + "wo"][l])


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens (b, t)`` against the
    encoder's output: the final hidden states ``(b, t, d_model)``."""
    x = params["embed"][tokens].to(cfg.dtype)
    x = _with_positions(x, torch.arange(x.shape[1], device=x.device), cfg)
    for l in range(cfg.n_layers):
        x = layer(cfg, lambda x, e, l=l: _decoder_layer(params, l, x, e, cfg),
                  x, enc_out)
    return _ln(params, "final_norm", x)


def loss_fn(params: Params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy through the tied head over the
    logical vocab: ``(loss, {"xent"})``."""
    h = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    xent = layers.chunked_softmax_xent(
        h, params["embed"].T, labels, chunk=cfg.xent_chunk,
        valid_vocab=cfg.vocab)
    return xent, {"xent": xent}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, n_frames: int,
               kv_dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Params:
    """The decode cache (zeros) on ``device``: the self-attention's ``{"k",
    "v"}`` ``(n_layers, batch, max_seq, kv_heads, head_dim)`` and the
    cross-attention's ``{"xk", "xv"}`` ``(n_layers, batch, n_frames,
    kv_heads, head_dim)``, all in ``kv_dtype``."""
    dev = resolve_device(device)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    self_shape = (L, batch, max_seq, kvh, hd)
    cross_shape = (L, batch, n_frames, kvh, hd)
    return {name: torch.zeros(shape, dtype=kv_dtype, device=dev)
            for name, shape in (("k", self_shape), ("v", self_shape),
                                ("xk", cross_shape), ("xv", cross_shape))}


def precompute_cross_kv(params: Params, cfg: ModelConfig,
                        enc_out: torch.Tensor, cache: Params) -> Params:
    """Fill the cache's ``xk``/``xv`` from the encoder's output (each
    layer's keys and values in its dtype, then in the cache's), in place;
    returns the cache."""
    for l in range(cfg.n_layers):
        k, v = _cross_kv(params, l, enc_out, cfg)
        cache["xk"][l] = k.to(cache["xk"].dtype)
        cache["xv"][l] = v.to(cache["xv"].dtype)
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``token (b, 1)`` at position ``pos`` -> ``(logits
    (b, vocab) f32, cache)``.  The sinusoid is the row of ``pos`` alone;
    each layer writes its K/V row at ``pos`` (in the cache's dtype, the
    cache updated in place), attends over rows ``0..pos`` of the cache
    converted to the compute dtype, then to the cross K/V converted to it;
    the head is the product of compute-dtype operands with an f32 result.
    Raises on ``pos`` outside the cache (the reference clamps)."""
    pos = int(pos)
    max_seq = cache["k"].shape[2]
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside the cache's {max_seq} rows")
    b = token.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim_
    x = params["embed"][token].to(cfg.dtype)
    x = _with_positions(x, torch.tensor([pos], device=x.device), cfg)
    for l in range(cfg.n_layers):
        ck, cv = cache["k"][l], cache["v"][l]
        wq, wk, wv, wo, biases = _attn_weights(params, DEC, l)
        q, k, v = layers.qkv(_ln(params, DEC + "ln_attn", x, l), wq, wk, wv,
                             nh, cfg.n_kv_heads, hd, biases)
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        out = layers.attention_scores(q, ck.to(q.dtype), cv.to(q.dtype),
                                      causal=True, q_offset=pos,
                                      kv_len=pos + 1)
        x = x + layers.matmul(out.reshape(b, 1, nh * hd), wo)
        x = x + _cross_attend(params, l, x, cache["xk"][l].to(x.dtype),
                              cache["xv"][l].to(x.dtype), cfg)
        x = x + _mlp(params, DEC, l, _ln(params, DEC + "ln_ff", x, l))
    h = _ln(params, "final_norm", x)[:, 0]
    logits = layers.wide_matmul(h, params["embed"].T)
    return logits[:, :cfg.vocab], cache
