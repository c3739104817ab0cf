"""Building blocks of the models (``repro.models.layers``).

Conventions carried over from the reference: activations in the config's
compute dtype, parameters stored in f32 and cast to the compute dtype
before each product, products accumulated in f32, softmax statistics and
the loss in f32.  Where the reference asks for an f32 result of a product
of compute-dtype operands (attention logits, vocab logits), the operands
are rounded to the compute dtype and the product taken in f32.  A float64
compute dtype keeps everything in float64 (``widen``): a float64
evaluation of the same model, which the reference has no counterpart of.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import tensor_parallel as tpm


def const(value: float, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """A 0-dim ``value`` in ``dtype`` on ``device``, made by a fill on the
    device: no host-to-device copy, so no wait for the card (which
    ``torch.tensor(value, device=...)`` makes), and an operand the card
    truly divides by (a Python number or a CPU scalar is taken as a
    multiplication by its reciprocal)."""
    return torch.full((), value, dtype=dtype, device=device)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype of statistics and f32 products: f32, or float64
    where ``x`` is float64."""
    return x if x.dtype == torch.float64 else x.float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``x``'s dtype; the result is in
    ``x``'s dtype (f32 accumulation inside the product)."""
    return torch.matmul(x, w.to(x.dtype))


def wide_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` rounded to ``x``'s dtype and the product taken
    in f32 (float64 for float64 ``x``): the reference's
    ``preferred_element_type=f32`` product of compute-dtype operands."""
    return torch.matmul(widen(x), widen(w.to(x.dtype)))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: the learned scale multiplies as ``1 + scale``."""
    xf = widen(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + widen(scale))).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm as the reference writes it: the mean and the mean of the
    squared deviations in f32, ``rsqrt(var + eps)``, then the scale and
    the bias, each read in f32 (``F.layer_norm`` computes the variance
    another way)."""
    xf = widen(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * widen(scale) + widen(bias)).to(x.dtype)


def sinusoid(positions: torch.Tensor, d: int,
             dtype: torch.dtype) -> torch.Tensor:
    """The sinusoidal position table ``(len(positions), d)`` in ``dtype``
    (``repro.models.encdec.sinusoidal_positions``): the angle ``pos /
    10000^(2 i / d)`` in f32 (float64 for a float64 ``dtype``), then
    ``[sin, cos]``.  Every division is a true one, so the card and the CPU
    agree; at large positions the f32 angle's rounding puts the table
    ~1e-4 from a float64 one, as the reference's."""
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    dev = positions.device
    pos = positions.to(wide)[:, None]
    dim = torch.arange(d // 2, dtype=wide, device=dev)[None, :]
    angle = pos / torch.pow(const(10000.0, wide, dev),
                            2 * dim / const(float(d), wide, dev))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves; ``x (b, t, heads, hd)``,
    ``positions (t,)``."""
    hd = x.shape[-1]
    xf = widen(x)
    freqs = 1.0 / (theta ** (
        torch.arange(0, hd, 2, dtype=xf.dtype, device=x.device) / hd))
    angles = positions.to(xf.dtype)[:, None] * freqs  # (t, hd/2)
    cos = torch.cos(angles)[:, None, :]  # (t, 1, hd/2)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_at(x: torch.Tensor, pos: int,
            theta: float = 10000.0) -> torch.Tensor:
    """RoPE of a ``(b, 1, heads, hd)`` decode step at position ``pos``
    (the reference's ``apply_rope(x, full((b, 1), pos))``)."""
    return apply_rope(x, torch.full((x.shape[1],), pos, device=x.device),
                      theta)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
        wv: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int,
        biases: Optional[Tuple[torch.Tensor, ...]] = None):
    """The query, key and value projections of ``x (b, t, d)`` as
    ``(b, t, heads, head_dim)`` (the reference's ``_qkv``): each product
    in ``x``'s dtype, then its bias ``(bq, bk, bv)``, cast to that dtype,
    added in it."""
    b, t, _ = x.shape
    q, k, v = matmul(x, wq), matmul(x, wk), matmul(x, wv)
    if biases is not None:
        bq, bk, bv = biases
        q, k, v = q + bq.to(q.dtype), k + bk.to(k.dtype), v + bv.to(v.dtype)
    return (q.view(b, t, n_heads, head_dim),
            k.view(b, t, n_kv_heads, head_dim),
            v.view(b, t, n_kv_heads, head_dim))


# sequence length at and above which ``attention`` takes the blockwise
# ``flash_attention`` (the reference's switch, models/layers.py);
# ``REPRO_DISABLE_FLASH=1`` at import keeps every length on the dense path
# (the reference's override, for a baseline measurement)
FLASH_THRESHOLD = (10 ** 12 if os.environ.get("REPRO_DISABLE_FLASH") == "1"
                   else 2048)


def _flash_setup(q: torch.Tensor, k: torch.Tensor):
    """``(qs, qw, group)``: ``q`` as ``(b, t, kvh, group, hd)`` scaled by
    ``1/sqrt(hd)`` in its own dtype, the same widened, and the group."""
    b, t, h, hd = q.shape
    group = h // k.shape[2]
    qs = q.reshape(b, t, k.shape[2], group, hd) * torch.tensor(
        1.0 / math.sqrt(hd), dtype=q.dtype)
    return qs, widen(qs), group


def _flash_logits(qw: torch.Tensor, kc: torch.Tensor, a: int, *,
                  window: int, attn_softcap: Optional[float], causal: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """One key block's logits ``(b, kvh, g, t, kc)`` (f32 of the widened
    operands, the softcap, -1e30 where masked), the softcap's ``tanh``
    (``None`` without one) and the visibility mask (``None`` where not
    ``causal``)."""
    logits = torch.einsum("btkgd,bskd->bkgts", qw, widen(kc))
    th = None
    if attn_softcap is not None:
        th = torch.tanh(logits / attn_softcap)
        logits = attn_softcap * th
    mask = None
    if causal:
        qp = torch.arange(qw.shape[1], device=qw.device)[:, None]
        kp = torch.arange(a, a + kc.shape[1], device=qw.device)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
        logits = logits.masked_fill(~mask, -1e30)
    return logits, th, mask


def _flash_forward(q, k, v, window, attn_softcap, k_chunk, causal):
    """The chunk loop: ``(out (b, t, h, hd) in q's dtype, the f32 output
    before the cast (b, kvh, g, t, hd), the running max m and the
    denominator l (b, kvh, g, t, 1))``."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    _, qw, group = _flash_setup(q, k)
    m = torch.full((b, kvh, group, t, 1), -1e30, dtype=qw.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, group, t, hd), dtype=qw.dtype,
                      device=q.device)
    for a in range(0, k.shape[1], k_chunk):
        kc, vc = k[:, a:a + k_chunk], v[:, a:a + k_chunk]
        logits, _, _ = _flash_logits(qw, kc, a, window=window,
                                     attn_softcap=attn_softcap,
                                     causal=causal)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bkgts,bskd->bkgtd", p, widen(vc))
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)
    return out, o, m, l


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int, attn_softcap: Optional[float],
                          k_chunk: int = 1024, causal: bool = True
                          ) -> torch.Tensor:
    """``flash_attention``'s forward as plain torch, differentiated by
    autograd through the chunks: every block's f32 logits and
    probabilities stay alive for the backward.  The oracle of
    ``flash_attention``'s own backward; the main path does not call it."""
    return _flash_forward(q, k, v, window, attn_softcap, k_chunk,
                          causal)[0]


class _FlashAttention(torch.autograd.Function):
    """The blockwise attention with a backward that recomputes each key
    block's logits and probabilities in turn.  It saves q, k, v, the f32
    output and the per-row max and denominator: nothing of a block's
    size."""

    @staticmethod
    def forward(ctx, q, k, v, window, attn_softcap, k_chunk, causal):
        out, o, m, l = _flash_forward(q, k, v, window, attn_softcap,
                                      k_chunk, causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = (window, attn_softcap, k_chunk, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, m, l = ctx.saved_tensors
        window, cap, k_chunk, causal = ctx.args
        b, t, h, hd = q.shape
        kvh = k.shape[2]
        _, qw, group = _flash_setup(q, k)
        # the cast to q's dtype and the layout, backwards: dO (b, kvh, g,
        # t, hd) in the widened dtype
        do = widen(dout).reshape(b, t, kvh, group, hd).permute(0, 2, 3, 1, 4)
        lc = torch.clamp(l, min=1e-30)
        delta = (do * o).sum(dim=-1, keepdim=True)  # sum_j P_j dP_j
        dqw = torch.zeros_like(qw)
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        for a in range(0, k.shape[1], k_chunk):
            kc, vc = k[:, a:a + k_chunk], v[:, a:a + k_chunk]
            logits, th, mask = _flash_logits(qw, kc, a, window=window,
                                             attn_softcap=cap, causal=causal)
            p = torch.exp(logits - m) / lc
            del logits
            dv[:, a:a + k_chunk] = torch.einsum(
                "bkgts,bkgtd->bskd", p, do).to(v.dtype)
            ds = p * (torch.einsum("bkgtd,bskd->bkgts", do, widen(vc))
                      - delta)
            del p
            if mask is not None:
                ds = ds.masked_fill(~mask, 0.0)
            if th is not None:
                ds = ds * (1 - th * th)  # d(cap tanh(z / cap)) / dz
            dqw += torch.einsum("bkgts,bskd->btkgd", ds, widen(kc))
            dk[:, a:a + k_chunk] = torch.einsum(
                "bkgts,btkgd->bskd", ds, qw).to(k.dtype)
            del ds, th
        # q's scaling by 1/sqrt(hd), in q's dtype, as autograd takes it
        dq = dqw.to(q.dtype) * torch.tensor(1.0 / math.sqrt(hd),
                                            dtype=q.dtype)
        return dq.reshape(b, t, h, hd), dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, attn_softcap: Optional[float],
                    k_chunk: int = 1024, causal: bool = True
                    ) -> torch.Tensor:
    """GQA attention of ``q (b, t, h, hd)`` over ``k, v (b, t, kvh,
    hd)`` in ``k_chunk``-key blocks with an online softmax
    (``repro.models.layers.flash_attention``): q scaled by ``1/sqrt(hd)``
    in its own dtype before the logits, f32 logits of the widened
    operands, the softcap, key ``kp`` visible from query ``qp`` iff
    ``qp - window < kp <= qp`` (others -1e30; every key where not
    ``causal``, and ``window`` is not read), the running max and
    denominator in f32, the probabilities kept in f32 into the product with
    the widened ``v``, and ``acc / max(l, 1e-30)`` in ``q``'s dtype.  A
    ragged last block is cut short, which is the reference's zero padding
    with the padded keys masked.  At most ``(b, kvh, g, t, k_chunk)``
    logits exist at once, in the forward and in the backward, which
    recomputes each block's logits and probabilities from q, k, v and the
    rows' max and denominator (``_FlashAttention``)."""
    return _FlashAttention.apply(q, k, v, window, attn_softcap, k_chunk,
                                 causal)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = False, q_offset: int = 0,
                     sliding_window: Optional[int] = None,
                     kv_len: Optional[int] = None,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Dense GQA attention of ``q (b, tq, h, hd)`` over ``k, v (b, tk,
    kvh, hd)``, which may come from another sequence (cross-attention):
    ``repro.models.layers.attention_scores``.  f32 logits of the widened
    operands truly divided by ``sqrt(hd)``, the softcap, the mask (with
    ``causal`` key ``kp`` visible from query ``qp`` iff ``kp <= qp +
    q_offset``; with ``sliding_window`` only keys ``kp > qp + q_offset -
    sliding_window``; with ``kv_len`` only keys ``kp < kv_len``; others
    -1e30),
    the f32 softmax, and the probabilities rounded to ``q``'s dtype before
    the product with ``v``: ``(b, tq, h, hd)``."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, tq, kvh, h // kvh, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", widen(qg), widen(k))
    logits = logits / const(math.sqrt(hd), logits.dtype, q.device)
    logits = softcap(logits, attn_softcap)
    kp = torch.arange(tk, device=q.device)[None, :]
    qp = torch.arange(tq, device=q.device)[:, None] + q_offset
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if sliding_window is not None:
        mask &= kp > qp - sliding_window
    if kv_len is not None:
        mask &= kp < kv_len
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, tq, h, hd)


def attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, wo: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
              window: int, attn_softcap: Optional[float],
              biases: Optional[Tuple[torch.Tensor, ...]] = None,
              causal: bool = True,
              tp: Optional["tpm.TensorParallel"] = None) -> torch.Tensor:
    """GQA self-attention over ``x (b, t, d)``: causal with a sliding
    window (key ``kp`` is visible from query ``qp`` iff ``qp - window <
    kp <= qp``), or over every key where not ``causal`` (``window`` is not
    read; an encoder).  From ``t >= FLASH_THRESHOLD`` on the blockwise
    ``flash_attention``, as the reference's forward; below it the dense
    ``attention_scores``, whose probabilities are rounded to the compute
    dtype before the product with ``v``.  ``biases`` are ``qkv``'s.

    ``tp`` (a ``tensor_parallel.TensorParallel`` of ``mp`` ranks): the
    weights are the rank's blocks, ``n_heads / mp`` query heads and
    ``n_kv_heads / mp`` kv heads of the projections (column parallel, ``x``
    entering through ``copy_in``) and their rows of ``wo`` (row parallel,
    summed over the group)."""
    b, t, _ = x.shape
    if tp is not None:
        x = tpm.copy_in(x, tp)
        n_heads, n_kv_heads = n_heads // tp.size, n_kv_heads // tp.size
    q, k, v = qkv(x, wq, wk, wv, n_heads, n_kv_heads, head_dim, biases)
    if rope_theta is not None:
        pos = torch.arange(t, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if t >= FLASH_THRESHOLD:
        out = flash_attention(q, k, v, window=window,
                              attn_softcap=attn_softcap, causal=causal)
    else:
        out = attention_scores(q, k, v, causal=causal,
                               sliding_window=window if causal else None,
                               attn_softcap=attn_softcap)
    if tp is not None:
        return tpm.row_parallel(out.reshape(b, t, n_heads * head_dim), wo,
                                tp)
    return matmul(out.reshape(b, t, n_heads * head_dim), wo)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA evaluates it: ``1 / (1 + exp(-x))``,
    every operation rounded to ``x``'s dtype (in bf16 ``torch.sigmoid``
    rounds once and differs on ~34% of the elements)."""
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: ``x * (1 / (1 + exp(-x)))``,
    every operation rounded to ``x``'s dtype (in bf16 a fused
    ``F.silu`` rounds once and differs on ~40% of the elements)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as XLA evaluates it: ``x * (0.5
    (1 + tanh(c (x + k x x x))))`` with the constants and every operation
    rounded to ``x``'s dtype (``F.gelu`` differs on ~43% of bf16
    elements)."""
    c = const(math.sqrt(2.0 / math.pi), x.dtype, x.device)
    k = const(0.044715, x.dtype, x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _activation(act: str, x: torch.Tensor) -> torch.Tensor:
    if act == "gelu":
        return gelu_tanh(x)
    if act == "silu":
        return silu(x)
    if act == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {act!r}")


def mlp(x: torch.Tensor, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
        w_down: torch.Tensor, act: str,
        tp: Optional["tpm.TensorParallel"] = None) -> torch.Tensor:
    """Gated MLP ``act(x W_gate) * (x W_up) W_down``, or the ungated
    ``act(x W_up) W_down`` where ``w_gate`` is ``None``; ``gelu`` is the
    tanh approximation (``jax.nn.gelu``'s default).  ``tp``: the rank's
    columns of ``w_gate``/``w_up`` and rows of ``w_down``
    (``attention``'s)."""
    down = matmul
    if tp is not None:
        x = tpm.copy_in(x, tp)

        def down(a, w):
            return tpm.row_parallel(a, w, tp)
    if w_gate is None:
        return down(_activation(act, matmul(x, w_up)), w_down)
    a = _activation(act, matmul(x, w_gate))
    return down(a * matmul(x, w_up), w_down)


def chunked_softmax_xent(h: torch.Tensor, w_vocab: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         logit_softcap: Optional[float] = None,
                         ignore_id: int = -1,
                         valid_vocab: Optional[int] = None,
                         tp: Optional["tpm.TensorParallel"] = None
                         ) -> torch.Tensor:
    """Mean token cross-entropy over sequence chunks, so at most
    ``(b, chunk, vocab)`` f32 logits exist at once.  Logits past
    ``valid_vocab`` (padded embedding rows) are masked to -1e30.  ``tp``:
    ``w_vocab`` is the rank's ``(d, vocab / mp)`` columns (global ids
    ``rank * vocab / mp ..``; ``h`` enters through ``copy_in``) and the
    logsumexp and the gold logit are taken over the group
    (``tensor_parallel.vocab_xent``)."""
    w = widen(w_vocab.to(h.dtype))
    tot = torch.zeros((), dtype=w.dtype, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    v0, width = 0, w.shape[-1]
    if tp is not None:
        h = tpm.copy_in(h, tp)
        v0, width = tp.rank * w.shape[-1], w.shape[-1] * tp.size
    for a in range(0, h.shape[1], chunk):
        logits = torch.matmul(widen(h[:, a:a + chunk]), w)
        logits = softcap(logits, logit_softcap)
        if valid_vocab is not None and valid_vocab < width:
            vmask = torch.arange(v0, v0 + logits.shape[-1],
                                 device=h.device) < valid_vocab
            logits = logits.masked_fill(~vmask, -1e30)
        lx = labels[:, a:a + chunk]
        valid = lx != ignore_id
        lsafe = torch.where(valid, lx, torch.zeros_like(lx))
        if tp is not None:
            nll = torch.where(valid, tpm.vocab_xent(logits, lsafe, tp),
                              torch.zeros((), dtype=logits.dtype,
                                          device=h.device))
            tot = tot + nll.sum()
            cnt = cnt + valid.sum()
            continue
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lsafe[..., None]).squeeze(-1)
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        tot = tot + nll.sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1)
