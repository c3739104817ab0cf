"""RWKV-6 "Finch" time-mix and channel-mix blocks (``repro.models.rwkv``,
arXiv:2404.05892), with the reference's simplification: per-projection
learned token-shift mixes and one shared LoRA on the data-dependent decay
``w_t = exp(-exp(w_base + lora(x_t)))``.

``params`` is one layer's ``tm/*`` (``mix (4, d)``, ``wr``, ``wk``,
``wv``, ``wg``, ``wo``, ``w_base``, ``w_lora_a``, ``w_lora_b``, ``u (h,
hd)``, ``ln_x/scale``) or ``cm/*`` (``mix (2, d)``, ``wk``, ``wv``,
``wr``) leaves with the prefix dropped.  The token-shift mixes, ``g``'s
silu, the LoRA's tanh, the channel-mix's squared relu and its sigmoid run
in the compute dtype, each operation rounded as XLA rounds it
(``layers.silu``, ``layers.sigmoid``); the decay, the scan and the
per-head group norm in f32.  Decode keeps a one-token shift buffer and the
``(hd, hd)`` WKV state per head, both f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers, ssm

Params = Dict[str, torch.Tensor]


def token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``x_{t-1}`` of ``x (b, t, d)`` with a zero (or the supplied
    ``prev (b, 1, d)``) first token."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x m + xs (1 - m)``, every operation in the compute dtype."""
    return x * m + xs * (1 - m)


def rkvw(params: Params, x: torch.Tensor, xs: torch.Tensor, n_heads: int):
    """``(r, k, v (b, t, h, hd), g (b, t, d), log_w (b, t, h, hd) f32)``
    of the time-mix from ``x`` and its shifted ``xs``."""
    b, t, d = x.shape
    hd = d // n_heads
    mix = params["mix"].to(x.dtype)
    xr, xk = _mix(x, xs, mix[0]), _mix(x, xs, mix[1])
    xv, xw = _mix(x, xs, mix[2]), _mix(x, xs, mix[3])
    r = layers.matmul(xr, params["wr"]).reshape(b, t, n_heads, hd)
    k = layers.matmul(xk, params["wk"]).reshape(b, t, n_heads, hd)
    v = layers.matmul(xv, params["wv"]).reshape(b, t, n_heads, hd)
    g = layers.silu(layers.matmul(xr, params["wg"]))
    lora = layers.matmul(torch.tanh(layers.matmul(xw, params["w_lora_a"])),
                         params["w_lora_b"])
    f = layers.widen(x).dtype
    log_w = -torch.exp(torch.clamp(params["w_base"].to(f) + lora.to(f),
                                   -8.0, 4.0)).reshape(b, t, n_heads, hd)
    return r, k, v, g, log_w


def head_groupnorm(scale: torch.Tensor, y: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RWKV's ``ln_x``: a GroupNorm per head (statistics over each head's
    channels), ``(b, t, h, hd) -> (b, t, h hd)`` in f32, the scale as
    ``1 + scale``."""
    b, t, h, hd = y.shape
    yf = layers.widen(y)
    mean = yf.mean(dim=-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(dim=-1, keepdim=True)
    yn = (yf - mean) * torch.rsqrt(var + eps)
    sc = (1.0 + scale.to(yf.dtype)).reshape(h, hd)
    return (yn * sc).reshape(b, t, h * hd)


def _readout(params: Params, y: torch.Tensor, g: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The WKV output ``y (b, t, h, hd)`` rounded to the compute dtype,
    group-normed, gated by ``g`` and projected."""
    y = head_groupnorm(params["ln_x/scale"], y.to(dtype)).to(dtype) * g
    return layers.matmul(y, params["wo"])


def timemix_fwd(params: Params, x: torch.Tensor, n_heads: int,
                chunk: int = 64) -> torch.Tensor:
    """The time-mix of ``x (b, t, d)`` (training): the u-bonus scan over
    the whole sequence from a zero state."""
    r, k, v, g, log_w = rkvw(params, x, token_shift(x), n_heads)
    y, _ = ssm.chunked_linear_attention(r, k, v, log_w, u=params["u"],
                                        chunk=chunk)
    return _readout(params, y, g, x.dtype)


def timemix_decode(params: Params, x: torch.Tensor, shift: torch.Tensor,
                   wkv: torch.Tensor, n_heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token ``x (b, 1, d)`` against the previous token ``shift (b, 1,
    d)`` (f32, cast to the compute dtype) and the state ``wkv (b, h, hd,
    hd)``: ``(out, new shift = x, new wkv)``."""
    r, k, v, g, log_w = rkvw(params, x, shift.to(x.dtype), n_heads)
    y, new_wkv = ssm.linear_attention_decode(
        r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], wkv, u=params["u"])
    return _readout(params, y[:, None], g, x.dtype), x, new_wkv


def channelmix_fwd(params: Params, x: torch.Tensor,
                   prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RWKV's MLP with token shift: ``sigmoid(xr W_r) * (relu(xk
    W_k)^2 W_v)``."""
    xs = token_shift(x, prev)
    mix = params["mix"].to(x.dtype)
    xk, xr = _mix(x, xs, mix[0]), _mix(x, xs, mix[1])
    k = torch.square(torch.relu(layers.matmul(xk, params["wk"])))
    return layers.sigmoid(layers.matmul(xr, params["wr"])) * layers.matmul(
        k, params["wv"])


def channelmix_decode(params: Params, x: torch.Tensor, shift: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token against the previous one (f32, cast to the compute
    dtype): ``(out, new shift = x)``."""
    return channelmix_fwd(params, x, prev=shift.to(x.dtype)), x
