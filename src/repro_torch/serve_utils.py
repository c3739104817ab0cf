"""Generation and evaluation on top of the decode path
(``repro.serve_utils``).

  sample_token       temperature / top-k / top-p sampling from logits
  generate           batched autoregressive generation (prefill by
                     stepping the decode path, then sampling)
  perplexity         teacher-forced eval over a token stream
  cast_for_serving_  the parameters cast once for decoding, in place

Randomness is injected: ``jax.random.categorical`` is ``argmax(logits +
gumbel)``, so ``sample_token`` takes the Gumbel noise itself or draws it
from a ``torch.Generator`` (the two frameworks' streams differ; parity
tests pass in the reference's ``jax.random.gumbel`` draws).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist import model_api
from repro_torch.kernels.ref import _div
from repro_torch.models.transformer import AttendFn, ModelConfig

Params = Dict[str, torch.Tensor]


def gumbel_noise(shape, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of f32 uniforms in
    ``[tiny, 1)``, the form ``jax.random.gumbel`` draws."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, *,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Token ids ``(b,)`` sampled from ``logits (b, vocab)`` f32;
    ``temperature <= 0`` is greedy.  The draw is ``argmax(logits +
    gumbel)`` with ``gumbel`` given, or drawn from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _div(logits, temperature)
    neg = torch.full((), -1e30, dtype=logits.dtype, device=logits.device)
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the smallest set with cumulative probability >= top_p
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, neg, logits)
    if gumbel is None:
        if generator is None:
            raise ValueError("sampling needs gumbel noise or a generator")
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(gumbel.to(logits.device) + logits, dim=-1)


def generate(params: Params, cfg: ModelConfig, prompts: torch.Tensor,
             gen_len: int, temperature: float = 1.0, top_k: int = 0,
             top_p: float = 0.0, cache: Optional[Params] = None,
             attend_fn: Optional[AttendFn] = None, *,
             gumbel: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             on_step: Optional[Callable[[int, torch.Tensor], None]] = None
             ) -> Tuple[torch.Tensor, Params]:
    """Prefill by stepping the decode path (exact), then sample
    ``gen_len`` tokens: ``(tokens (b, gen_len), cache)``.  The cache
    defaults to an f32 one of ``prompt_len + gen_len`` rows on the
    prompts' device; step ``i``'s noise is ``gumbel[i]`` (``(gen_len, b,
    vocab)``) when given, else drawn from ``generator``.  ``on_step(pos,
    logits)`` is called after the decode step at each position."""
    b, plen = prompts.shape
    max_seq = plen + gen_len
    if cache is None:
        cache = model_api.make_cache(cfg, b, max_seq, kv_dtype=torch.float32,
                                     device=prompts.device)
    logits = None
    for i in range(plen):
        logits, cache = model_api.decode(params, cfg, prompts[:, i:i + 1],
                                         cache, i, attend_fn=attend_fn)
        if on_step is not None:
            on_step(i, logits)
    out = []
    for j, i in enumerate(range(plen, max_seq)):
        tok = sample_token(logits, temperature, top_k, top_p,
                           gumbel=None if gumbel is None else gumbel[j],
                           generator=generator)
        out.append(tok)
        logits, cache = model_api.decode(params, cfg, tok[:, None], cache, i,
                                         attend_fn=attend_fn)
        if on_step is not None:
            on_step(i, logits)
    return torch.stack(out, dim=1), cache


def perplexity(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               labels: torch.Tensor) -> float:
    """exp(mean token NLL) under teacher forcing."""
    with torch.no_grad():
        loss, _ = model_api.loss(params, cfg, tokens=tokens, labels=labels)
    return math.exp(float(loss))


# leaves the model reads in f32 (``.astype(f32)`` in the reference):
# RWKV's decay base and bonus, Mamba2's decay, skip and (in decode)
# convolution, the layernorm biases; with the norm scales they stay f32
# for serving
F32_LEAVES = ("/scale", "/bias", "/w_base", "/u", "/A_log", "/D",
              "/dt_bias", "/conv_w", "/conv_b")


def cast_for_serving_(params: Params, cfg: ModelConfig) -> None:
    """Cast the parameters for decoding in place, leaf by leaf: every
    matrix and the embedding to the compute dtype once (the cast
    ``layers.matmul`` and the decode step make per product, so the results
    are the same bits), the leaves the model reads in f32
    (``F32_LEAVES``: the norm scales and the layernorm biases, RWKV's
    ``w_base`` and ``u``, Mamba2's ``A_log``, ``D``, ``dt_bias``,
    ``conv_w``, ``conv_b``) left as they are; the attention biases, added
    in the compute dtype, are cast.  Each leaf's cast replaces its f32 original in ``params``
    before the next leaf is cast, so the f32 and the cast copies of the
    whole model never live at once (the originals are freed when the
    caller holds no other reference to them)."""
    for k in list(params):
        if not k.endswith(F32_LEAVES):
            params[k] = params[k].to(cfg.dtype)
