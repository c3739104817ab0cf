"""Decoder-only transformer (``repro.models.transformer``): config,
parameter layout, init, forward and loss, and the decode side: the cache
and one decode step against it.  Four families here, and the config,
layout and init of a fifth, the encoder-decoder (``models/encdec.py``):

  dense         pre/post-norm GQA attention + gated MLP  [gemma2, stablelm,
                                                          deepseek, internvl]
  moe           GQA attention + top-k MoE feed-forward (+ shared experts)
                                                         [qwen2-moe, qwen3-moe]
  rwkv          RWKV-6 time-mix + channel-mix            [rwkv6-7b]
  mamba_hybrid  Mamba2 layers, with one weight-shared attention+MLP block
                before every ``shared_attn_every`` of them   [zamba2-2.7b]

Parameters are a flat ``{name: tensor}`` dict whose names and order are the
reference's ``jax.tree_util.tree_flatten_with_path`` of ``init_params``
(``checkpoint._flatten_with_names`` naming, e.g. ``blocks/attn/wq``).  That
order defines the packed client workspace (``dist/comm_ws.py``) and with it
which client owns which coordinate, so it must not change.  Every
``blocks/*`` leaf is stacked ``(n_layers, ...)`` for the same reason; the
hybrid's ``shared_attn/*`` leaves are not stacked, and their gradient is
the sum over the block's uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import layers, moe, rwkv, ssm
from repro_torch.models import tensor_parallel as tpm

Params = Dict[str, torch.Tensor]

# the window a global layer decodes with (the reference's
# ``jnp.iinfo(jnp.int32).max // 2``): wider than any cache
GLOBAL_WINDOW = (2 ** 31 - 1) // 2

FAMILIES = ("dense", "moe", "rwkv", "mamba_hybrid", "encdec")
# what tensor parallelism does not cover yet
_TP_LATER = ("tensor parallelism covers the dense family without a prefix; "
             "the other families' layers and the prefix are ROADMAP A9c")
# the reference's fixed widths: RWKV's decay LoRA, Mamba2's convolution
DECAY_LORA = 64
CONV_WIDTH = 4
# the MoE load-balance loss's weight in the total loss
AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``repro.models.transformer.ModelConfig`` that the
    port's families read.  ``dtype`` is the compute dtype; parameters are
    stored in ``param_dtype`` (f32 by default; the client workspace is f32
    and holds bf16 parameters as their exact f32 values, rounded back to
    bf16 wherever the round writes them, as the reference's round casts
    them).  ``remat`` (on by default, as the reference's) recomputes each
    layer's activations in the backward instead of keeping them
    (``torch.utils.checkpoint`` where the reference takes
    ``jax.checkpoint``)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | rwkv | mamba_hybrid | encdec
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
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0  # the shared experts fused into one MLP
    renormalize: bool = True
    # ssm / hybrid
    d_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 6
    tie_embeddings: bool = True
    prefix_len: int = 0  # stub frontend: embeddings prepended to the text
    scale_embed: bool = False  # gemma multiplies embed by sqrt(d_model)
    # encoder-decoder (family "encdec"): n_layers counts the decoder's
    n_encoder_layers: int = 0
    n_frames: int = 0  # encoder input length (stub frontend frames)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    xent_chunk: int = 512
    scan_chunk: int = 64  # linear-attention chunk size
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} is not ported; the "
                             f"port has {FAMILIES}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128 (logits past the
        logical vocab are masked in the loss)."""
        return -(-self.vocab // 128) * 128

    @property
    def n_attn(self) -> int:
        """Attention applications per token through the K/V cache: one per
        layer (dense, moe; the decoder's self-attention of encdec), none
        (rwkv), one per group of ``shared_attn_every`` layers
        (mamba_hybrid)."""
        if self.family == "rwkv":
            return 0
        if self.family == "mamba_hybrid":
            return self.n_layers // self.shared_attn_every
        return self.n_layers

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


Spec = List[Tuple[str, Tuple[int, ...]]]


def _attn_specs(pre: str, st: Tuple[int, ...], cfg: ModelConfig,
                bias: bool) -> Spec:
    d = cfg.d_model
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    biases = [(pre + "attn/bk", st + (kv,)), (pre + "attn/bq", st + (q,)),
              (pre + "attn/bv", st + (kv,))] if bias else []
    return [*biases,
            (pre + "attn/wk", st + (d, kv)), (pre + "attn/wo", st + (q, d)),
            (pre + "attn/wq", st + (d, q)), (pre + "attn/wv", st + (d, kv))]


def _mlp_specs(pre: str, st: Tuple[int, ...], d: int, F: int) -> Spec:
    return [(pre + "w_down", st + (F, d)), (pre + "w_gate", st + (d, F)),
            (pre + "w_up", st + (d, F))]


def _block_specs(cfg: ModelConfig) -> Spec:
    """The ``blocks/*`` leaves, stacked ``(n_layers, ...)``."""
    st, d = (cfg.n_layers,), cfg.d_model
    if cfg.family in ("dense", "moe"):
        norms = ["ln_attn", "ln_attn_post", "ln_ff", "ln_ff_post"] \
            if cfg.post_norm else ["ln_attn", "ln_ff"]
        if cfg.family == "dense":
            ff = _mlp_specs("blocks/mlp/", st, d, cfg.d_ff)
        else:
            E, F, S = cfg.num_experts, cfg.moe_d_ff, cfg.shared_d_ff
            shared = [*_mlp_specs("blocks/moe/shared/", st, d, S),
                      ("blocks/moe/shared_gate", st + (d, 1))] if S else []
            ff = [("blocks/moe/router", st + (d, E)), *shared,
                  ("blocks/moe/w_down", st + (E, F, d)),
                  ("blocks/moe/w_gate", st + (E, d, F)),
                  ("blocks/moe/w_up", st + (E, d, F))]
        return [*_attn_specs("blocks/", st, cfg, cfg.qkv_bias),
                *[(f"blocks/{nm}/scale", st + (d,)) for nm in norms], *ff]
    if cfg.family == "rwkv":
        h, F = cfg.n_heads, cfg.d_ff
        return [
            ("blocks/cm/mix", st + (2, d)), ("blocks/cm/wk", st + (d, F)),
            ("blocks/cm/wr", st + (d, d)), ("blocks/cm/wv", st + (F, d)),
            ("blocks/ln_cm/scale", st + (d,)),
            ("blocks/ln_tm/scale", st + (d,)),
            ("blocks/tm/ln_x/scale", st + (d,)),
            ("blocks/tm/mix", st + (4, d)),
            ("blocks/tm/u", st + (h, d // h)),
            ("blocks/tm/w_base", st + (d,)),
            ("blocks/tm/w_lora_a", st + (d, DECAY_LORA)),
            ("blocks/tm/w_lora_b", st + (DECAY_LORA, d)),
            *[(f"blocks/tm/{w}", st + (d, d))
              for w in ("wg", "wk", "wo", "wr", "wv")],
        ]
    di = cfg.ssm_expand * d
    nh, ds = di // cfg.ssm_head_dim, cfg.d_state
    return [
        ("blocks/ln/scale", st + (d,)),
        ("blocks/mamba/A_log", st + (nh,)), ("blocks/mamba/D", st + (nh,)),
        ("blocks/mamba/conv_b", st + (di,)),
        ("blocks/mamba/conv_w", st + (CONV_WIDTH, di)),
        ("blocks/mamba/dt_bias", st + (nh,)),
        ("blocks/mamba/norm/scale", st + (di,)),
        ("blocks/mamba/w_in", st + (d, 2 * di + 2 * ds + nh)),
        ("blocks/mamba/w_out", st + (di, d)),
    ]


def param_specs(cfg: ModelConfig) -> Spec:
    """``[(name, shape)]`` of every parameter leaf, in the reference's
    ``jax.tree.leaves`` order (dict keys sorted as Python strings at every
    level, so ``A_log`` and ``D`` come first): the ``blocks/*`` leaves,
    ``embed``, ``final_norm``, then ``lm_head``, ``prefix_proj`` and the
    hybrid's ``shared_attn/*`` where the config has them.  The
    encoder-decoder's are ``encdec.param_specs``'."""
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.param_specs(cfg)
    d = cfg.d_model
    shared = [] if cfg.family != "mamba_hybrid" else [
        *_attn_specs("shared_attn/", (), cfg, False),
        ("shared_attn/ln_attn/scale", (d,)),
        ("shared_attn/ln_ff/scale", (d,)),
        *_mlp_specs("shared_attn/mlp/", (), d, cfg.d_ff)]
    return [
        *_block_specs(cfg),
        ("embed", (cfg.padded_vocab, d)),
        ("final_norm/scale", (d,)),
        *([] if cfg.tie_embeddings
          else [("lm_head", (d, cfg.padded_vocab))]),
        *([("prefix_proj", (d, d))] if cfg.prefix_len else []),
        *shared,
    ]


# leaves initialised to a constant (the reference's init): name -> value
_CONST_INIT = {"blocks/tm/mix": 0.5, "blocks/cm/mix": 0.5,
               "blocks/tm/w_base": -1.0, "blocks/tm/u": 0.5,
               "blocks/mamba/A_log": 0.0, "blocks/mamba/dt_bias": 0.0,
               "blocks/mamba/conv_b": 0.0, "blocks/mamba/D": 1.0,
               "blocks/moe/shared_gate": 0.0}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Random f32 parameters with the reference's init scales: matrices
    (experts, ``lm_head`` and ``prefix_proj`` included) ``N(0,
    1/in_dim)``, the embedding ``N(0, 0.02^2)``, norm scales ones, q/k/v
    and layernorm biases zeros; RWKV's mixes 0.5, ``w_base`` -1, ``u`` 0.5 and
    ``w_lora_b`` a tenth of its ``N(0, 1/in_dim)``; Mamba2's ``conv_w``
    ``N(0, 0.01)``, ``A_log``, ``dt_bias`` and ``conv_b`` zeros, ``D``
    ones; the shared experts' gate zeros.  Each leaf is drawn in f32 and
    stored in ``cfg.param_dtype``.  ``generator`` must live on
    ``device``; the draws are the port's own (a reference init is carried
    over with ``repro_torch.convert``)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    params: Params = {}
    for name, shape in param_specs(cfg):
        if name.endswith("/scale") or name in _CONST_INIT:
            params[name] = torch.full(shape, _CONST_INIT.get(name, 1.0),
                                      dtype=pd, device=dev)
            continue
        if name.rsplit("/", 1)[-1] in ("bq", "bk", "bv", "bias"):
            params[name] = torch.zeros(shape, dtype=pd, device=dev)
            continue
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        if name == "embed":
            scale = 0.02
        elif name == "blocks/mamba/conv_w":
            scale = 0.1
        else:
            scale = 1.0 / math.sqrt(shape[-2])
            if name == "blocks/tm/w_lora_b":
                scale *= 0.1
        params[name] = w.mul_(scale).to(pd)
    return params


def layer(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``, one layer's body: under ``cfg.remat``, while autograd
    records, its activations are recomputed in the backward instead of
    kept (non-reentrant checkpointing, which ``torch.autograd.grad``
    takes; the bodies draw no random numbers, so no generator state is
    stashed)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _sub(p: Params, prefix: str, l: Optional[int] = None) -> Params:
    """The leaves under ``prefix`` with it dropped, layer ``l`` of each
    where the leaves are stacked."""
    n = len(prefix)
    return {k[n:]: (v if l is None else v[l])
            for k, v in p.items() if k.startswith(prefix)}


def _attn_weights(p: Params, prefix: str, l: Optional[int] = None):
    """``(wq, wk, wv, wo, biases)`` of the attention under ``prefix``
    (layer ``l`` where stacked); ``biases`` is ``(bq, bk, bv)`` or
    ``None``."""
    a = _sub(p, prefix + "attn/", l)
    biases = tuple(a[nm] for nm in ("bq", "bk", "bv")) if "bq" in a else None
    return a["wq"], a["wk"], a["wv"], a["wo"], biases


def _attend(x: torch.Tensor, p: Params, prefix: str, l: Optional[int],
            cfg: ModelConfig, window: int, softcap: Optional[float],
            tp: Optional[tpm.TensorParallel] = None) -> torch.Tensor:
    """Causal self-attention of ``x`` with the weights under ``prefix``
    (the rank's heads under ``tp``)."""
    wq, wk, wv, wo, biases = _attn_weights(p, prefix, l)
    return layers.attention(
        x, wq, wk, wv, wo, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta, window=window,
        attn_softcap=softcap, biases=biases, tp=tp)


def _feed_forward(p: Params, l: int, h: torch.Tensor, cfg: ModelConfig,
                  tp: Optional[tpm.TensorParallel] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``l``'s MLP (dense; tensor parallel under ``tp``) or MoE
    (with its load-balance loss)."""
    if cfg.family == "moe":
        if tp is not None:
            raise NotImplementedError(_TP_LATER)
        y, aux = moe.moe_fwd(_sub(p, "blocks/moe/", l), h, cfg.top_k,
                             cfg.act, cfg.renormalize)
        return y, aux["load_balance"]
    return layers.mlp(h, p["blocks/mlp/w_gate"][l], p["blocks/mlp/w_up"][l],
                      p["blocks/mlp/w_down"][l], cfg.act, tp=tp), None


def _block(p: Params, l: int, x: torch.Tensor, cfg: ModelConfig,
           window: int, tp: Optional[tpm.TensorParallel] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A dense or MoE layer: ``(x, the MoE load-balance loss or None)``;
    ``tp``: the rank's blocks of the weights, the norms replicated."""
    t = x.shape[1]
    # 0 -> global: a window longer than the sequence masks nothing
    eff_window = window if window > 0 else t + 1
    h = layers.rmsnorm(p["blocks/ln_attn/scale"][l], x)
    h = _attend(h, p, "blocks/", l, cfg, eff_window, cfg.attn_softcap, tp)
    if cfg.post_norm:
        h = layers.rmsnorm(p["blocks/ln_attn_post/scale"][l], h)
    x = x + h
    h = layers.rmsnorm(p["blocks/ln_ff/scale"][l], x)
    h, aux = _feed_forward(p, l, h, cfg, tp)
    if cfg.post_norm:
        h = layers.rmsnorm(p["blocks/ln_ff_post/scale"][l], h)
    return x + h, aux


def _shared_block(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """The hybrid's weight-shared attention + MLP block (the reference's
    ``layers.attention_fwd``: the config's sliding window, no softcap)."""
    h = layers.rmsnorm(p["shared_attn/ln_attn/scale"], x)
    x = x + _attend(h, p, "shared_attn/", None, cfg,
                    cfg.sliding_window or x.shape[1] + 1, None)
    h = layers.rmsnorm(p["shared_attn/ln_ff/scale"], x)
    return x + layers.mlp(h, p["shared_attn/mlp/w_gate"],
                          p["shared_attn/mlp/w_up"],
                          p["shared_attn/mlp/w_down"], cfg.act)


def _rwkv_layer(p: Params, l: int, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """An RWKV-6 layer: time-mix, then channel-mix."""
    x = x + rwkv.timemix_fwd(_sub(p, "blocks/tm/", l),
                             layers.rmsnorm(p["blocks/ln_tm/scale"][l], x),
                             cfg.n_heads, chunk=cfg.scan_chunk)
    return x + rwkv.channelmix_fwd(
        _sub(p, "blocks/cm/", l),
        layers.rmsnorm(p["blocks/ln_cm/scale"][l], x))


def _mamba_layer(p: Params, l: int, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """A Mamba2 layer of the hybrid."""
    return x + ssm.mamba2_fwd(_sub(p, "blocks/mamba/", l),
                              layers.rmsnorm(p["blocks/ln/scale"][l], x),
                              cfg.d_state, chunk=cfg.scan_chunk)


def _groups(cfg: ModelConfig) -> int:
    """The hybrid's groups: a shared block then ``shared_attn_every``
    Mamba2 layers each."""
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_every {cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           tp: Optional[tpm.TensorParallel] = None) -> torch.Tensor:
    """The token embeddings in the compute dtype, scaled by sqrt(d_model)
    (rounded to the compute dtype, as the reference does) for gemma;
    under ``tp`` from the rank's vocab rows (``vocab_embed``)."""
    if tp is not None:
        x = tpm.vocab_embed(params["embed"], tokens, tp).to(cfg.dtype)
    else:
        x = params["embed"][tokens].to(cfg.dtype)
    if cfg.scale_embed:
        x = x * layers.const(math.sqrt(cfg.d_model), torch.float32,
                             x.device).to(cfg.dtype)
    return x


def forward_aux(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                tp: Optional[tpm.TensorParallel] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens (b, t)`` -> ``(final hidden states (b, P + t, d_model),
    the MoE load-balance loss summed over the layers)`` (the reference's
    ``forward``; the loss is 0 outside the MoE family).
    ``prefix_embeds (b, P, d_model)`` (a stub frontend's patch
    embeddings), in the compute dtype and through ``prefix_proj`` where
    the model has it, go before the token embeddings.

    ``tp`` (a ``tensor_parallel.TensorParallel``): ``params`` are the
    rank's blocks under ``sharding.params_pspecs`` and the layers are
    tensor parallel; the dense family without a prefix only (the other
    families' layers and the prefix are ROADMAP A9c).  The hidden states
    come out the same on every rank."""
    if tp is not None and (cfg.family != "dense"
                           or prefix_embeds is not None):
        raise NotImplementedError(_TP_LATER)
    x = _embed(params, cfg, tokens, tp)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.dtype)
        if "prefix_proj" in params:
            pe = layers.matmul(pe, params["prefix_proj"])
        x = torch.cat([pe, x], dim=1)
    auxes = []
    if cfg.family in ("dense", "moe"):
        for l, w in enumerate(cfg.layer_windows()):
            x, aux = layer(cfg, lambda x, l=l, w=w: _block(params, l, x, cfg,
                                                           w, tp), x)
            if aux is not None:
                auxes.append(aux)
    elif cfg.family == "rwkv":
        for l in range(cfg.n_layers):
            x = layer(cfg, lambda x, l=l: _rwkv_layer(params, l, x, cfg), x)
    else:
        every = cfg.shared_attn_every
        for g in range(_groups(cfg)):
            # the weight-shared block is not recomputed, as in the reference
            x = _shared_block(params, x, cfg)
            for l in range(g * every, (g + 1) * every):
                x = layer(cfg, lambda x, l=l: _mamba_layer(params, l, x, cfg),
                          x)
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return layers.rmsnorm(params["final_norm/scale"], x), aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The final hidden states of ``forward_aux``."""
    return forward_aux(params, cfg, tokens, prefix_embeds)[0]


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            tp: Optional[tpm.TensorParallel] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the text positions (the prefix's
    are dropped) through ``lm_head_weight``, plus ``AUX_WEIGHT`` times the
    MoE load-balance loss: ``(loss, {"xent", "moe_aux"})``.  The router's
    z-loss is computed and not added, as in the reference.  ``tp``:
    ``forward_aux``'s, the head's vocab split over the group; the loss is
    the same on every rank."""
    h, aux = forward_aux(params, cfg, tokens, prefix_embeds, tp)
    if prefix_embeds is not None:
        h = h[:, prefix_embeds.shape[1]:]
    xent = layers.chunked_softmax_xent(
        h, lm_head_weight(params, cfg), labels, chunk=cfg.xent_chunk,
        logit_softcap=cfg.final_softcap, valid_vocab=cfg.vocab, tp=tp,
    )
    return xent + AUX_WEIGHT * aux, {"xent": xent, "moe_aux": aux}


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
    """The decode cache (zeros) on ``device``: ``{"k", "v"}`` of
    ``(n_attn, batch, max_seq, n_kv_heads, head_dim)`` in ``kv_dtype``
    for the attention (each layer's, or each use of the hybrid's shared
    block), and in f32 RWKV's ``shift_tm``, ``shift_cm`` ``(L, batch, 1,
    d_model)`` and ``wkv`` ``(L, batch, h, hd, hd)``, Mamba2's ``conv``
    ``(L, batch, 3, d_inner)`` and ``ssm`` ``(L, batch, heads, d_state,
    head_dim)``."""
    dev = resolve_device(device)
    L = cfg.n_layers

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        return {"shift_tm": zeros((L, batch, 1, cfg.d_model)),
                "shift_cm": zeros((L, batch, 1, cfg.d_model)),
                "wkv": zeros((L, batch, cfg.n_heads, hd, hd))}
    shape = (cfg.n_attn, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": zeros(shape, kv_dtype), "v": zeros(shape, kv_dtype)}
    if cfg.family == "mamba_hybrid":
        di = cfg.ssm_expand * cfg.d_model
        cache = {"conv": zeros((L, batch, CONV_WIDTH - 1, di)),
                 "ssm": zeros((L, batch, di // cfg.ssm_head_dim, cfg.d_state,
                               cfg.ssm_head_dim)), **cache}
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: int,
                attend_fn: Optional[AttendFn] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``token (b, 1)`` at position ``pos`` -> ``(logits
    (b, vocab) f32, cache)``.  The cache is updated in place (the
    reference returns an updated copy): each attention writes its K/V row
    at ``pos`` and attends with ``attend_fn(q, cache_k, cache_v, pos,
    window)`` or, when it is ``None``, the plain ``_decode_scores_dyn``
    (global layers and the hybrid's shared block with the window
    ``GLOBAL_WINDOW``); the recurrent states are replaced by their next
    ones.  Raises on ``pos`` outside a K/V cache, where the reference's
    ``dynamic_update_slice`` clamps to the last row."""
    pos = int(pos)
    if "k" in cache:
        max_seq = cache["k"].shape[2]
        if not 0 <= pos < max_seq:
            raise ValueError(f"pos {pos} outside the cache's {max_seq} rows")
    x = _embed(params, cfg, token)
    if cfg.family in ("dense", "moe"):
        for l, w in enumerate(cfg.layer_windows()):
            window = w if w > 0 else GLOBAL_WINDOW
            h = layers.rmsnorm(params["blocks/ln_attn/scale"][l], x)
            h = _attention_decode_dyn(params, "blocks/", l, h,
                                      cache["k"][l], cache["v"][l], pos,
                                      cfg, window, cfg.attn_softcap,
                                      attend_fn)
            if cfg.post_norm:
                h = layers.rmsnorm(params["blocks/ln_attn_post/scale"][l], h)
            x = x + h
            h = layers.rmsnorm(params["blocks/ln_ff/scale"][l], x)
            h, _ = _feed_forward(params, l, h, cfg)
            if cfg.post_norm:
                h = layers.rmsnorm(params["blocks/ln_ff_post/scale"][l], h)
            x = x + h
    elif cfg.family == "rwkv":
        for l in range(cfg.n_layers):
            h, shift, wkv = rwkv.timemix_decode(
                _sub(params, "blocks/tm/", l),
                layers.rmsnorm(params["blocks/ln_tm/scale"][l], x),
                cache["shift_tm"][l], cache["wkv"][l], cfg.n_heads)
            cache["shift_tm"][l] = shift
            cache["wkv"][l] = wkv
            x = x + h
            h, shift = rwkv.channelmix_decode(
                _sub(params, "blocks/cm/", l),
                layers.rmsnorm(params["blocks/ln_cm/scale"][l], x),
                cache["shift_cm"][l])
            cache["shift_cm"][l] = shift
            x = x + h
    else:
        every = cfg.shared_attn_every
        for g in range(_groups(cfg)):
            h = layers.rmsnorm(params["shared_attn/ln_attn/scale"], x)
            x = x + _attention_decode_dyn(
                params, "shared_attn/", None, h, cache["k"][g],
                cache["v"][g], pos, cfg, GLOBAL_WINDOW, None, attend_fn)
            h = layers.rmsnorm(params["shared_attn/ln_ff/scale"], x)
            x = x + layers.mlp(h, params["shared_attn/mlp/w_gate"],
                               params["shared_attn/mlp/w_up"],
                               params["shared_attn/mlp/w_down"], cfg.act)
            for l in range(g * every, (g + 1) * every):
                h, conv, state = ssm.mamba2_decode(
                    _sub(params, "blocks/mamba/", l),
                    layers.rmsnorm(params["blocks/ln/scale"][l], x),
                    cache["conv"][l], cache["ssm"][l], cfg.d_state)
                cache["conv"][l] = conv
                cache["ssm"][l] = state
                x = x + h
    h = layers.rmsnorm(params["final_norm/scale"], x)[:, 0]
    logits = layers.wide_matmul(h, lm_head_weight(params, cfg))
    return layers.softcap(logits[:, :cfg.vocab], cfg.final_softcap), cache


def _attention_decode_dyn(p: Params, prefix: str, l: Optional[int],
                          x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                          window: int, softcap: Optional[float],
                          attend_fn: Optional[AttendFn]) -> torch.Tensor:
    """The attention under ``prefix`` (layer ``l`` where stacked) for one
    position: q/k/v, RoPE at ``pos``, the K/V row written at ``pos`` (in
    the cache's dtype), attention over the cache, the output
    projection."""
    b = x.shape[0]
    wq, wk, wv, wo, biases = _attn_weights(p, prefix, l)
    q, k, v = layers.qkv(x, wq, wk, wv, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, biases)
    if cfg.rope_theta is not None:
        q = layers.rope_at(q, pos, cfg.rope_theta)
        k = layers.rope_at(k, pos, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    if attend_fn is not None:
        out = attend_fn(q, cache_k, cache_v, pos, window)
    else:
        out = _decode_scores_dyn(q, cache_k, cache_v, pos, window, softcap)
    return layers.matmul(out.reshape(b, 1, cfg.n_heads * cfg.head_dim_), wo)


def _decode_scores_dyn(q: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, pos: int, window: int,
                       softcap: Optional[float]) -> torch.Tensor:
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
    logits = layers.softcap(logits, softcap)
    kpos = torch.arange(S, device=q.device)
    mask = (kpos <= pos) & (kpos > pos - window)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, cache_v.to(q.dtype))
    return out.reshape(b, 1, h, hd)
