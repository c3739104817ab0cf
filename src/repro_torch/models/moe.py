"""Mixture-of-Experts feed-forward with top-k routing
(``repro.models.moe``): the router with its load-balance and z terms, the
dense and the gather dispatch, and the shared expert behind its sigmoid
gate.

``params`` is one layer's ``moe/*`` leaves with the prefix dropped:
``router (d, E)``, ``w_gate``/``w_up (E, d, F)``, ``w_down (E, F, d)``
and, with shared experts, ``shared/w_gate``, ``shared/w_up``,
``shared/w_down`` and ``shared_gate (d, 1)``.

Numerics follow the reference step by step: the router's logits are the
compute-dtype product widened to f32; the expert products are f32 results
of compute-dtype operands (``layers.wide_matmul``'s convention), their
activation is taken in f32 and the hidden units rounded to the compute
dtype.  Top-k ties go to the lower expert index, as ``jax.lax.top_k``
does: the top k are the first k of a stable descending sort
(``torch.topk`` makes no such promise).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Dict[str, torch.Tensor]

DISPATCHES = ("auto", "dense", "gather")


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, largest first, ties broken towards the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Params, x: torch.Tensor, k: int, renormalize: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """``(top_idx (..., k), top_p (..., k), aux)``: f32 router
    probabilities, their top ``k`` (renormalized to sum 1 if asked), and
    the Switch load-balance loss ``E sum_e f_e p_e`` and the router
    z-loss ``mean(logsumexp(logits)^2)``."""
    num_experts = params["router"].shape[-1]
    logits = layers.widen(layers.matmul(x, params["router"]))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = top_k(probs, k)
    if renormalize:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    hot = F.one_hot(top_idx, num_experts).to(probs.dtype).sum(-2)
    lead = tuple(range(hot.dim() - 1))
    frac_tokens = (hot > 0).to(probs.dtype).mean(dim=lead)
    mean_probs = probs.mean(dim=lead)
    lb = num_experts * (frac_tokens * mean_probs).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return top_idx, top_p, {"load_balance": lb, "router_z": z}


def combine_weights(top_idx: torch.Tensor, top_p: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Dense ``(..., E)`` combine weights from top-k routing."""
    hot = F.one_hot(top_idx, num_experts).to(top_p.dtype)
    return (hot * top_p[..., None]).sum(dim=-2)


def resolve_dispatch(dispatch: str, tokens: int, k: int,
                     num_experts: int) -> str:
    """``"dense"`` or ``"gather"``: ``"auto"`` gathers when few tokens
    touch few experts (``tokens k <= E``, the decode step), unless the
    environment's ``REPRO_MOE_DISPATCH`` forces one (the reference's
    measurement knob)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch {dispatch!r} not in {DISPATCHES}")
    if dispatch != "auto":
        return dispatch
    forced = os.environ.get("REPRO_MOE_DISPATCH")
    if forced in ("dense", "gather"):
        return forced
    return "gather" if tokens * k <= num_experts else "dense"


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return layers.silu(g)
    if act == "gelu":
        return layers.gelu_tanh(g)
    raise ValueError(f"unknown activation {act!r}")


def experts(params: Params, x: torch.Tensor, top_idx: torch.Tensor,
            top_p: torch.Tensor, act: str, dispatch: str) -> torch.Tensor:
    """The routed experts' weighted sum ``(b, t, d)`` in ``x``'s dtype for
    a resolved ``dispatch``.  ``"dense"``: every expert sees every token
    and the combine weights zero the unchosen ones before the down
    projection; ``"gather"``: each token's ``k`` experts' matrices are
    gathered (only ``k`` of ``E`` experts' weights are read)."""
    dt = x.dtype
    xw = layers.widen(x)
    if dispatch == "gather":
        wg = layers.widen(params["w_gate"][top_idx].to(dt))  # (b,t,k,d,F)
        wu = layers.widen(params["w_up"][top_idx].to(dt))
        wd = layers.widen(params["w_down"][top_idx].to(dt))  # (b,t,k,F,d)
        g = torch.einsum("btd,btkdf->btkf", xw, wg)
        u = torch.einsum("btd,btkdf->btkf", xw, wu)
        h = (_act(g, act) * u).to(dt)
        # h p is exact in f32 (two compute-dtype factors), then the sum
        # over (k, f) in f32, as the reference's contraction path
        hp = layers.widen(h) * layers.widen(top_p.to(dt))[..., None]
        return torch.einsum("btkf,btkfd->btd", hp, wd).to(dt)
    num_experts = params["router"].shape[-1]
    cw = combine_weights(top_idx, top_p, num_experts).to(dt)
    g = torch.einsum("btd,edf->btef", xw,
                     layers.widen(params["w_gate"].to(dt)))
    u = torch.einsum("btd,edf->btef", xw, layers.widen(params["w_up"].to(dt)))
    h = (_act(g, act) * u).to(dt)
    h = h * cw[..., None]
    return torch.einsum("btef,efd->btd", layers.widen(h),
                        layers.widen(params["w_down"].to(dt))).to(dt)


def moe_fwd(params: Params, x: torch.Tensor, k: int, act: str = "silu",
            renormalize: bool = True, dispatch: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE feed-forward of ``x (b, t, d)``: ``(y, aux)``.  With shared
    experts, ``sigmoid(x W_gate)`` (f32, rounded to the compute dtype)
    times the shared MLP is added."""
    top_idx, top_p, aux = route(params, x, k, renormalize)
    b, t, _ = x.shape
    mode = resolve_dispatch(dispatch, b * t, k, params["router"].shape[-1])
    y = experts(params, x, top_idx, top_p, act, mode)
    if "shared_gate" in params:
        gate = layers.sigmoid(
            layers.widen(layers.matmul(x, params["shared_gate"]))).to(x.dtype)
        y = y + gate * layers.mlp(x, params["shared/w_gate"],
                                  params["shared/w_up"],
                                  params["shared/w_down"], act)
    return y, aux
