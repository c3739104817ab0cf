"""Optimizers (``repro.optim.optimizers``): ``sgd``, ``momentum``,
``adamw``, ``global_norm`` and ``clip_by_global_norm`` on a tensor or a
dict of tensors.

Each optimizer is an ``(init, update)`` pair like the reference's, but
``update(grads, state, params)`` works in place: it writes the new
parameters into ``params`` and the new moments into the state's tensors,
and returns ``(params, state)``.  The TAMUNA local step updates the leaf
views of its workspace rows this way, so no copy of a client's parameters
is made.

The arithmetic is the reference's, operation by operation in f32, with no
fused multiply-add: ``torch.add(a, b, alpha=c)`` rounds ``a + c b`` once,
where the reference rounds the product and then the sum, so products are
formed first and added after.  AdamW's bias corrections are f32 scalars
computed on the host with numpy (``np.float32(b1) ** np.float32(count)``
rounds as XLA's ``pow`` does on every count the tests reach; torch's f32
``pow`` does not), and a large leaf is updated in column chunks of
``CHUNK`` elements, so at most two chunk-sized temporaries are alive
whatever the leaf's size.  torch's f32 ``sqrt`` on the CPU is not
correctly rounded (about 0.6% of random inputs are one ulp off), so there
the square root is taken in f64 and rounded once to f32, which is the
correctly rounded f32 result that XLA and CUDA's ``sqrtf`` give.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple, Union

import numpy as np
import torch

Params = Union[torch.Tensor, Dict[str, torch.Tensor]]

# elements per chunk of the in-place AdamW update (64 MB of f32)
CHUNK = 1 << 24

__all__ = ["Optimizer", "AdamState", "sgd", "momentum", "adamw",
           "adamw_bias_scales", "adamw_leaf", "global_norm",
           "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]


def _items(tree: Params) -> Iterator[Tuple[Any, torch.Tensor]]:
    """``(key, tensor)`` pairs in the reference's leaf order: a tensor is
    one leaf, a dict's leaves go in sorted key order."""
    if isinstance(tree, torch.Tensor):
        yield None, tree
    else:
        for k in sorted(tree):
            yield k, tree[k]


def _like(tree: Params, fn: Callable[[torch.Tensor], torch.Tensor]
          ) -> Params:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: fn(v) for k, v in tree.items()}


def _leaf(tree: Params, key) -> torch.Tensor:
    return tree if key is None else tree[key]


def sgd(lr: float) -> Optimizer:
    """``p <- p - lr g`` (the gradient cast to p's type)."""

    def init(params):
        return ()

    def update(grads, state, params):
        for k, p in _items(params):
            p.sub_(_leaf(grads, k).to(p.dtype) * lr)
        return params, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """Heavy ball: ``m <- beta m + g`` in f32, then ``p <- p - lr m``."""

    def init(params):
        return _like(params, lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device))

    def update(grads, state, params):
        for k, p in _items(params):
            m = _leaf(state, k)
            m.mul_(beta).add_(_leaf(grads, k).to(torch.float32))
            p.sub_(m.to(p.dtype) * lr)
        return params, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    """AdamW's moments (f32, the parameters' structure) and the step count
    (an int32 scalar, here a host integer)."""

    mu: Params
    nu: Params
    count: int


def adamw_bias_scales(count: int, b1: float, b2: float
                      ) -> Tuple[float, float]:
    """``1 / (1 - b1**c)`` and ``1 / (1 - b2**c)`` at step ``count``, each
    an f32 power, difference and division as the reference computes them;
    returned as the Python floats of those f32 values."""
    c = np.float32(np.int32(count))
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** c)),
            float(one / (one - np.float32(b2) ** c)))


def _sqrt_(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, in place."""
    if t.device.type == "cpu":
        return t.copy_(t.to(torch.float64).sqrt_())
    return t.sqrt_()


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for a in range(0, flat.numel(), CHUNK):
        yield flat[a:a + CHUNK]


def adamw_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, *, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float, mu_hat: float,
               nu_hat: float) -> None:
    """One AdamW step of one leaf, in place on ``p``, ``mu`` and ``nu``
    (contiguous, of one shape; ``mu``/``nu`` f32): ``mu = b1 mu + (1-b1)
    g``, ``nu = b2 nu + (1-b2) g^2``, ``upd = (mu mu_hat) / (sqrt(nu
    nu_hat) + eps)`` (plus ``weight_decay p`` when it is nonzero), ``p = p
    - lr upd``, each operation rounded in f32 as the reference's
    (``mu_hat``/``nu_hat`` from ``adamw_bias_scales``)."""
    c1, c2 = 1 - b1, 1 - b2
    for pc, gc, mc, nc in zip(_chunks(p), _chunks(g), _chunks(mu),
                              _chunks(nu)):
        gf = gc.to(torch.float32)
        t = torch.mul(gf, c1)
        mc.mul_(b1).add_(t)
        torch.mul(gf, gf, out=t)
        t.mul_(c2)
        nc.mul_(b2).add_(t)
        torch.mul(nc, nu_hat, out=t)
        _sqrt_(t).add_(eps)
        upd = torch.mul(mc, mu_hat)
        upd.div_(t)
        if weight_decay:
            torch.mul(pc.to(torch.float32), weight_decay, out=t)
            upd.add_(t)
        upd.mul_(lr)
        if pc.dtype == torch.float32:
            pc.sub_(upd)
        else:
            pc.copy_(pc.to(torch.float32).sub_(upd))
        del t, upd


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments; ``update`` advances the count by one."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return AdamState(mu=_like(params, z), nu=_like(params, z), count=0)

    def update(grads, state, params):
        count = int(state.count) + 1
        mu_hat, nu_hat = adamw_bias_scales(count, b1, b2)
        for k, p in _items(params):
            adamw_leaf(p, _leaf(grads, k), _leaf(state.mu, k),
                       _leaf(state.nu, k), lr=lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, mu_hat=mu_hat,
                       nu_hat=nu_hat)
        return params, AdamState(state.mu, state.nu, count)

    return Optimizer(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(x^2))`` in f32 (0-dim tensor)."""
    total = None
    for _, x in _items(tree):
        xf = x.to(torch.float32)
        sq = torch.sum(xf * xf)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    """Every leaf times ``min(1, max_norm / max(norm, 1e-9))`` (new
    tensors, each in its leaf's type)."""
    norm = global_norm(tree)
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    scale = torch.minimum(one, torch.full_like(norm, max_norm)
                          / torch.clamp(norm, min=1e-9))
    return _like(tree, lambda x: (x * scale).to(x.dtype))
