"""Building blocks of the dense path (``repro.models.layers``).

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
from typing import Optional

import torch
import torch.nn.functional as F


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
        wv: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int):
    """The query, key and value projections of ``x (b, t, d)`` as
    ``(b, t, heads, head_dim)`` (the reference's ``_qkv`` without
    biases)."""
    b, t, _ = x.shape
    return (matmul(x, wq).view(b, t, n_heads, head_dim),
            matmul(x, wk).view(b, t, n_kv_heads, head_dim),
            matmul(x, wv).view(b, t, n_kv_heads, head_dim))


# sequence length at and above which ``attention`` takes the blockwise
# ``flash_attention`` (the reference's switch, models/layers.py)
FLASH_THRESHOLD = 2048


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, attn_softcap: Optional[float],
                    k_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention of ``q (b, t, h, hd)`` over ``k, v (b, t, kvh,
    hd)`` in ``k_chunk``-key blocks with an online softmax
    (``repro.models.layers.flash_attention``): q scaled by ``1/sqrt(hd)``
    in its own dtype before the logits, f32 logits of the widened
    operands, the softcap, key ``kp`` visible from query ``qp`` iff
    ``qp - window < kp <= qp`` (others -1e30), the running max and
    denominator in f32, the probabilities kept in f32 into the product with
    the widened ``v``, and ``acc / max(l, 1e-30)`` in ``q``'s dtype.  A
    ragged last block is cut short, which is the reference's zero padding
    with the padded keys masked.  At most ``(b, kvh, g, t, k_chunk)``
    logits exist at once."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, t, kvh, group, hd) * torch.tensor(
        1.0 / math.sqrt(hd), dtype=q.dtype)
    qw = widen(qg)
    qp = torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, kvh, group, t, 1), -1e30, dtype=qw.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, group, t, hd), dtype=qw.dtype,
                      device=q.device)
    for a in range(0, s, k_chunk):
        kc, vc = k[:, a:a + k_chunk], v[:, a:a + k_chunk]
        logits = torch.einsum("btkgd,bskd->bkgts", qw, widen(kc))
        logits = softcap(logits, attn_softcap)
        kp = torch.arange(a, a + kc.shape[1], device=q.device)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
        logits = logits.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bkgts,bskd->bkgtd", p, widen(vc))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, wo: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
              window: int, attn_softcap: Optional[float]) -> torch.Tensor:
    """Causal GQA self-attention over ``x (b, t, d)`` with a sliding
    window: key ``kp`` is visible from query ``qp`` iff
    ``qp - window < kp <= qp``.  From ``t >= FLASH_THRESHOLD`` on the
    blockwise ``flash_attention``, as the reference's forward; below it
    the dense form, whose probabilities are rounded to the compute dtype
    before the product with ``v``."""
    b, t, _ = x.shape
    q, k, v = qkv(x, wq, wk, wv, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        pos = torch.arange(t, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if t >= FLASH_THRESHOLD:
        out = flash_attention(q, k, v, window=window,
                              attn_softcap=attn_softcap)
        return matmul(out.reshape(b, t, n_heads * head_dim), wo)
    group = n_heads // n_kv_heads
    qg = q.view(b, t, n_kv_heads, group, head_dim)
    logits = torch.einsum(
        "btkgd,bskd->bkgts", widen(qg), widen(k)
    ) / math.sqrt(head_dim)
    logits = softcap(logits, attn_softcap)
    qp = torch.arange(t, device=x.device)[:, None]
    kp = torch.arange(t, device=x.device)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return matmul(out.reshape(b, t, n_heads * head_dim), wo)


def mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
        w_down: torch.Tensor, act: str) -> torch.Tensor:
    """Gated MLP ``act(x W_gate) * (x W_up) W_down``; ``gelu`` is the tanh
    approximation (``jax.nn.gelu``'s default)."""
    if act == "gelu":
        a = F.gelu(matmul(x, w_gate), approximate="tanh")
    elif act == "silu":
        a = F.silu(matmul(x, w_gate))
    elif act == "relu":
        a = F.relu(matmul(x, w_gate))
    else:
        raise ValueError(f"unknown activation {act!r}")
    return matmul(a * matmul(x, w_up), w_down)


def chunked_softmax_xent(h: torch.Tensor, w_vocab: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         logit_softcap: Optional[float] = None,
                         ignore_id: int = -1,
                         valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy over sequence chunks, so at most
    ``(b, chunk, vocab)`` f32 logits exist at once.  Logits past
    ``valid_vocab`` (padded embedding rows) are masked to -1e30."""
    w = widen(w_vocab.to(h.dtype))
    tot = torch.zeros((), dtype=w.dtype, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for a in range(0, h.shape[1], chunk):
        logits = torch.matmul(widen(h[:, a:a + chunk]), w)
        logits = softcap(logits, logit_softcap)
        if valid_vocab is not None and valid_vocab < logits.shape[-1]:
            vmask = torch.arange(logits.shape[-1],
                                 device=h.device) < valid_vocab
            logits = logits.masked_fill(~vmask, -1e30)
        lx = labels[:, a:a + chunk]
        valid = lx != ignore_id
        lsafe = torch.where(valid, lx, torch.zeros_like(lx))
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lsafe[..., None]).squeeze(-1)
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        tot = tot + nll.sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1)
