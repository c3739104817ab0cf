"""Building blocks of the dense path (``repro.models.layers``).

Conventions carried over from the reference: activations in the config's
compute dtype, parameters stored in f32 and cast to the compute dtype
before each product, products accumulated in f32, softmax statistics and
the loss in f32.  Where the reference asks for an f32 result of a product
of compute-dtype operands (attention logits, vocab logits), the operands
are rounded to the compute dtype and the product taken in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``x``'s dtype; the result is in
    ``x``'s dtype (f32 accumulation inside the product)."""
    return torch.matmul(x, w.to(x.dtype))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: the learned scale multiplies as ``1 + scale``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves; ``x (b, t, heads, hd)``,
    ``positions (t,)``."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    angles = positions.float()[:, None] * freqs  # (t, hd/2)
    cos = torch.cos(angles)[:, None, :]  # (t, 1, hd/2)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor, wo: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
              window: int, attn_softcap: Optional[float]) -> torch.Tensor:
    """Causal GQA self-attention over ``x (b, t, d)`` with a sliding
    window: key ``kp`` is visible from query ``qp`` iff
    ``qp - window < kp <= qp``."""
    b, t, _ = x.shape
    q = matmul(x, wq).view(b, t, n_heads, head_dim)
    k = matmul(x, wk).view(b, t, n_kv_heads, head_dim)
    v = matmul(x, wv).view(b, t, n_kv_heads, head_dim)
    if rope_theta is not None:
        pos = torch.arange(t, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    group = n_heads // n_kv_heads
    qg = q.view(b, t, n_kv_heads, group, head_dim)
    logits = torch.einsum(
        "btkgd,bskd->bkgts", qg.float(), k.float()
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
    w = w_vocab.to(h.dtype).float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for a in range(0, h.shape[1], chunk):
        logits = torch.matmul(h[:, a:a + chunk].float(), w)
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
