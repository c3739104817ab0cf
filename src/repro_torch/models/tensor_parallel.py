"""Tensor-parallel layers of the dense family over a model group.

The reference splits each parameter leaf over the mesh's ``model`` axis
(``repro.dist.sharding._leaf_pspec``) and lets GSPMD partition the forward,
so it computes the unsharded function; the port partitions it by hand, in
the Megatron form the rules imply: the column-parallel products (``wq wk
wv w_gate w_up`` and the tied vocab head) take the rank's output columns,
the row-parallel ones (``wo w_down``) the matching rows of the contraction,
the embedding the rank's vocab rows.  A rank holds ``n_heads / mp`` query
heads and ``n_kv_heads / mp`` kv heads of every layer, whole.  Four
``torch.autograd.Function`` s sum over the model group:

* ``copy_in``: the identity forward, a sum of the gradient backward, at the
  input of each column-parallel product;
* ``reduce_out``: a sum forward, the identity backward, after each
  row-parallel product, whose partial products are taken in f32 and
  rounded to the compute dtype once, after the sum;
* ``vocab_embed``: the rank's vocab rows looked up for the tokens they hold
  (0 elsewhere), then summed: exactly one rank holds each token's row, so
  the sum is the unsharded lookup bitwise;
* ``vocab_xent``: the cross-entropy over vocab-sharded logits, ``MAX`` then
  ``SUM`` for the logsumexp and a ``SUM`` for the gold logit, with the
  analytic backward (softmax minus one-hot, on the rank's columns).

Every sum runs in f32 (a bf16 activation or gradient is widened exactly
first; a float64 evaluation stays float64), so the products that split
the contraction differ from the unsharded ones by reassociation only.
Every rank runs the same sequence of collectives, in the forward, in a
recomputing checkpoint and in the backward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List

import torch


@dataclasses.dataclass
class TensorParallel:
    """A rank's side of the model axis: the model group ``pg`` (``None``:
    the default group), the rank's index ``rank`` in it and its ``size``.
    ``sizes`` and ``seconds`` record every sum's element count and the
    host time it held its caller (gloo: the whole sum)."""

    pg: Any
    rank: int
    size: int
    sizes: List[int] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.size < 1 or not 0 <= self.rank < self.size:
            raise ValueError(f"bad TensorParallel(rank={self.rank}, "
                             f"size={self.size})")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="sum"``) or maxed (``"max"``) over the model
        group in place; returns ``t``."""
        import torch.distributed as dist

        self.sizes.append(t.numel())
        t0 = time.perf_counter()
        if self.size > 1:
            dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                                   else dist.ReduceOp.SUM), group=self.pg)
        self.seconds.append(time.perf_counter() - t0)
        return t


def _summed(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``t`` summed over the group in f32 (float64 stays float64; a copy),
    back in its dtype."""
    wide = torch.float64 if t.dtype == torch.float64 else torch.float32
    return tp.all_reduce(t.to(wide, copy=True)).to(t.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.tp), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _summed(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group."""
    return _CopyIn.apply(x, tp)


def reduce_out(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the model group (in f32); the gradient passes."""
    return _ReduceOut.apply(x, tp)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 tp: TensorParallel) -> torch.Tensor:
    """``x @ w`` of a row-parallel weight: the rank's partial product of
    ``x`` and ``w`` rounded to ``x``'s dtype (float64 stays float64), in
    f32, summed over the group, then rounded to ``x``'s dtype once."""
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    part = torch.matmul(x.to(wide), w.to(x.dtype).to(wide))
    return reduce_out(part, tp).to(x.dtype)


def vocab_embed(embed: torch.Tensor, tokens: torch.Tensor,
                tp: TensorParallel) -> torch.Tensor:
    """The rows of the tokens of the vocab-sharded ``embed`` (the rank's
    ``(V / mp, d)`` block, rows ``rank * V / mp ..``), in its dtype."""
    v_loc = embed.shape[0]
    local = tokens - tp.rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = embed[local.clamp(0, v_loc - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_out(rows, tp)


class _VocabXent(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[target]`` over logits whose
    vocab is split over the group; ``target`` is the rank-local column
    (outside ``[0, V_loc)`` on the other ranks)."""

    @staticmethod
    def forward(ctx, logits, target, tp):
        v_loc = logits.shape[-1]
        m = tp.all_reduce(logits.amax(dim=-1), "max")
        e = torch.exp(logits - m[..., None])
        se = tp.all_reduce(e.sum(dim=-1))
        inside = (target >= 0) & (target < v_loc)
        tc = target.clamp(0, v_loc - 1)
        gold = torch.where(inside, logits.gather(-1, tc[..., None])[..., 0],
                           torch.zeros_like(m))
        gold = tp.all_reduce(gold)
        ctx.save_for_backward(e.div_(se[..., None]), tc, inside)
        return m + torch.log(se) - gold

    @staticmethod
    def backward(ctx, g):
        p, tc, inside = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, tc[..., None],
                       torch.where(inside, -g, torch.zeros_like(g))[..., None])
        return d, None, None


def vocab_xent(logits: torch.Tensor, target: torch.Tensor,
               tp: TensorParallel) -> torch.Tensor:
    """``(b, t)`` negative log-likelihoods of the global ``target`` ids
    under the rank's ``(b, t, V / mp)`` columns of the logits."""
    local = target - tp.rank * logits.shape[-1]
    return _VocabXent.apply(logits, local, tp)
