"""State-space / linear-attention machinery (``repro.models.ssm``): the
chunked scan and the Mamba2 block.

The recurrence (Mamba2/SSD and RWKV-6) is

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{K x V}
    y_t = r_t^T S_{t-1} + (r_t . (u . k_t)) v_t  (u-bonus form, RWKV)
or  y_t = r_t^T S_t                              (in-state form, Mamba)

with a data-dependent decay ``w_t in (0, 1)^K``.  ``chunked_linear_attention``
evaluates it chunk by chunk with intra-chunk products, in the reference's
factorization: inside a chunk the keys are scaled by ``exp(-L_s)`` and the
queries by ``exp(P_t)`` (``L`` the running sum of ``log w``), which can
overflow f32 at extreme decays exactly where the reference's does.

Mamba2's ``params`` are one layer's ``mamba/*`` leaves with the prefix
dropped: ``w_in (d, 2 d_inner + 2 d_state + n_heads)``, ``conv_w (4,
d_inner)``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm/scale``,
``w_out``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact for large ``x``
    (``F.softplus`` returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def chunked_linear_attention(
        r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, u: Optional[torch.Tensor] = None,
        state: Optional[torch.Tensor] = None, chunk: int = 64,
        include_current: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r, k (b, t, h, K)``, ``v (b, t, h, V)``, ``log_w (b, t, h, K) <=
    0`` and optionally the bonus ``u (h, K)`` and an initial ``state (b,
    h, K, V)`` -> ``(y (b, t, h, V), final state)``, in f32 (float64 for
    float64 inputs).  ``t`` is padded to a multiple of ``chunk`` with
    zeros (``log w = 0``: the padding leaves the state as it is)."""
    b, t, h, K = r.shape
    V = v.shape[-1]
    f = layers.widen(r).dtype
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t

    def chunks(a: torch.Tensor, width: int) -> torch.Tensor:
        a = a.to(f)
        if pad:
            a = torch.cat([a, a.new_zeros((b, pad, h, width))], dim=1)
        # (n_chunks, b, h, chunk, width)
        return a.reshape(b, n_chunks, chunk, h, width).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lw = chunks(r, K), chunks(k, K), chunks(v, V), \
        chunks(log_w, K)
    S = (torch.zeros((b, h, K, V), dtype=f, device=r.device)
         if state is None else state.to(f))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for i in range(n_chunks):
        R, Kk, Vv, LW = rc[i], kc[i], vc[i], lw[i]  # (b, h, C, K/V)
        L = torch.cumsum(LW, dim=2)  # L_t = sum_{j<=t} log w_j
        # the Mamba form reads S_t (use L), the RWKV form S_{t-1} (L - LW)
        P = L if include_current else L - LW
        Ltot = L[:, :, -1:, :]  # (b, h, 1, K)
        r_in = R * torch.exp(P)
        y1 = torch.einsum("bhck,bhkv->bhcv", r_in, S)
        k_ = Kk * torch.exp(-L)
        A = torch.einsum("bhck,bhdk->bhcd", r_in, k_)
        A = torch.where(tri, A, torch.zeros((), dtype=f, device=r.device))
        y2 = torch.einsum("bhcd,bhdv->bhcv", A, Vv)
        ys.append(y1 + y2)
        k_out = Kk * torch.exp(Ltot - L)
        S = torch.exp(Ltot).transpose(2, 3) * S + torch.einsum(
            "bhck,bhcv->bhkv", k_out, Vv)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(
        b, n_chunks * chunk, h, V)[:, :t]
    if include_current:
        y = y + torch.einsum("bthk,bthk,bthv->bthv", r.to(f), k.to(f),
                             v.to(f))
    elif u is not None:
        bonus = torch.einsum("bthk,hk,bthk->bth", r.to(f), u.to(f), k.to(f))
        y = y + bonus[..., None] * v.to(f)
    return y, S


def linear_attention_decode(
        r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, state: torch.Tensor,
        u: Optional[torch.Tensor] = None, include_current: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: ``r, k, log_w (b, h, K)``, ``v (b, h,
    V)``, ``state (b, h, K, V)`` -> ``(y (b, h, V), new state)`` in f32."""
    f = layers.widen(r).dtype
    r, k, v, log_w = (a.to(f) for a in (r, k, v, log_w))
    state = state.to(f)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    new_state = torch.exp(log_w)[..., None] * state + kv
    if include_current:
        y = torch.einsum("bhk,bhkv->bhv", r, new_state)
    else:
        y = torch.einsum("bhk,bhkv->bhv", r, state)
        if u is not None:
            y = y + torch.einsum("bhk,hk,bhk->bh", r, u.to(f), k)[..., None] \
                * v
    return y, new_state


# --------------------------------------------------------------------------
# Mamba2 block (SSD): scalar per-head decay a_t = exp(-softplus(dt) A)
# --------------------------------------------------------------------------


def mamba_dims(params: Params) -> Tuple[int, int, int, int]:
    """``(conv_width, d_inner, n_heads, head_dim)``."""
    conv_width, d_inner = params["conv_w"].shape
    n_heads = params["A_log"].shape[0]
    return conv_width, d_inner, n_heads, d_inner // n_heads


def _split(proj: torch.Tensor, d_inner: int, d_state: int):
    """``x, z, B, C, dt`` of the fused input projection."""
    i = [d_inner, 2 * d_inner, 2 * d_inner + d_state,
         2 * d_inner + 2 * d_state]
    return (proj[..., :i[0]], proj[..., i[0]:i[1]], proj[..., i[1]:i[2]],
            proj[..., i[2]:i[3]], proj[..., i[3]:])


def _decay(params: Params, dt: torch.Tensor):
    """``(dt, A)``: ``softplus(dt + dt_bias)`` and ``-exp(A_log)``, f32."""
    f = layers.widen(dt).dtype
    dt = softplus(dt.to(f) + params["dt_bias"].to(f))
    return dt, -torch.exp(params["A_log"].to(f))


def _gate_out(params: Params, y: torch.Tensor, z: torch.Tensor
              ) -> torch.Tensor:
    """``rmsnorm(y) * silu(z)`` through the output projection."""
    y = layers.rmsnorm(params["norm/scale"], y) * layers.silu(z)
    return layers.matmul(y, params["w_out"])


def mamba2_fwd(params: Params, x_in: torch.Tensor, d_state: int,
               chunk: int = 64) -> torch.Tensor:
    """Training-mode forward, ``(b, t, d_model) -> (b, t, d_model)``: the
    causal depthwise convolution as the reference's sum over the taps in
    order (each product and sum in the compute dtype, then ``+ conv_b``),
    the scan in the in-state form."""
    b, t, _ = x_in.shape
    conv_width, d_inner, n_heads, head_dim = mamba_dims(params)
    proj = layers.matmul(x_in, params["w_in"])
    x, z, Bm, Cm, dt = _split(proj, d_inner, d_state)
    xp = torch.cat([x.new_zeros((b, conv_width - 1, d_inner)), x], dim=1)
    cw = params["conv_w"].to(x.dtype)
    xc = xp[:, 0:t] * cw[0]
    for i in range(1, conv_width):
        xc = xc + xp[:, i:i + t] * cw[i]
    xc = layers.silu(xc + params["conv_b"].to(x.dtype))
    dt, A = _decay(params, dt)  # (b, t, h), (h,)
    log_w = (dt * A).unsqueeze(-1).expand(b, t, n_heads, d_state)
    xh = layers.widen(xc.reshape(b, t, n_heads, head_dim))
    v = xh * dt[..., None]
    r = Cm[:, :, None, :].expand(b, t, n_heads, d_state)
    k = Bm[:, :, None, :].expand(b, t, n_heads, d_state)
    y, _ = chunked_linear_attention(r, k, v, log_w, chunk=chunk,
                                    include_current=True)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, t, d_inner).to(x_in.dtype)
    return _gate_out(params, y, z)


def mamba2_decode(params: Params, x_in: torch.Tensor,
                  conv: torch.Tensor, ssm: torch.Tensor, d_state: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token, ``(b, 1, d_model) -> (b, 1, d_model)``, against the
    convolution's last ``conv_width - 1`` inputs ``conv (b, w - 1,
    d_inner)`` and the state ``ssm (b, h, d_state, head_dim)``: ``(out,
    new conv, new ssm)``.  The new input joins the (f32) buffer in f32
    and the convolution is taken in f32, as the reference's promotion
    does."""
    b = x_in.shape[0]
    conv_width, d_inner, n_heads, head_dim = mamba_dims(params)
    proj = layers.matmul(x_in[:, 0], params["w_in"])
    x, z, Bm, Cm, dt = _split(proj, d_inner, d_state)
    f = layers.widen(conv).dtype
    conv_buf = torch.cat([conv.to(f), x[:, None].to(f)], dim=1)
    xc = torch.einsum("bcd,cd->bd", conv_buf, params["conv_w"].to(f)) \
        + params["conv_b"].to(f)
    xc = layers.silu(xc).to(x.dtype)
    dt, A = _decay(params, dt)  # (b, h), (h,)
    log_w = (dt * A).unsqueeze(-1).expand(b, n_heads, d_state)
    xh = layers.widen(xc.reshape(b, n_heads, head_dim))
    v = xh * dt[..., None]
    r = Cm[:, None, :].expand(b, n_heads, d_state)
    k = Bm[:, None, :].expand(b, n_heads, d_state)
    y, new_ssm = linear_attention_decode(r, k, v, log_w, ssm,
                                         include_current=True)
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(b, d_inner).to(x_in.dtype)
    out = _gate_out(params, y, z)
    return out[:, None], conv_buf[:, 1:], new_ssm
