"""The blocked-template uplink (``repro.dist.block_uplink``): the
reduce-scatter-shaped aggregation of ``uplink="block_rs"``.

The blocked template (``masks.block_template_mask``) keeps exactly ``s``
owners per coordinate but gives every client ``s`` contiguous chunks of
each leaf: chunk ``j`` is the sum of its ``s`` owners' chunk-``j`` slices,
with ownership the closed form ``(chunk - slot - off) mod c < s`` and the
round's permutation restricted to the cyclic shift ``off``, the subgroup
that keeps the blocks contiguous.

``block_rs_aggregate`` runs the port's ``comm_ws`` blocked step over
client-stacked leaves: ``impl="ws"``/``"dense"`` are the reference's plain
implementations (``comm_ws.blocked_comm_leaves``) and ``"pallas"`` (and
``"auto"``) packs the leaves into an f32 workspace and runs the CUDA
kernel path (``comm_ws.blocked_comm``: ``masked_sum`` and ``h_update``
with the block band).  ``_leaf_aggregate`` is the reference's first
implementation (a padded ``(n, n, chunk)`` gather and a materialized
ownership delta at full participation), kept as the plain prior path the
tests hold the others against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist import comm_ws
from repro_torch.dist import wire as wire_mod
from repro_torch.kernels import ref

__all__ = ["block_rs_aggregate"]


def _leaf_aggregate(xl: torch.Tensor, hl: torch.Tensor, off: int, n: int,
                    s: int, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf ``(n, *shape)`` at full participation: blocks of
    ``ceil(D / n)`` (the last padded), block ``j``'s mean of the ``s``
    rows ``(j - off - t) mod n``, h updated on owned blocks and every row
    set to the mean.  Returns new ``(x, h)`` in the leaves' types."""
    D = xl[0].numel()
    chunk = -(-D // n)
    pad = n * chunk - D
    xf = xl.reshape(n, D).to(torch.float32)
    hf = hl.reshape(n, D).to(torch.float32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
        hf = torch.nn.functional.pad(hf, (0, pad))
    xb = xf.reshape(n, n, chunk)  # (client, block, chunk)
    j = torch.arange(n, dtype=torch.int64, device=xl.device)
    acc = torch.zeros(n, chunk, dtype=torch.float32, device=xl.device)
    for t in range(s):
        acc = acc + xb[torch.remainder(j - off - t, n), j]
    out = ref._div(acc, s)  # (block, chunk)
    # client i owns blocks (i + off) .. (i + off + s - 1) mod n
    own = torch.remainder(j[None, :] - j[:, None] - off, n) < s
    delta = scale * own[:, :, None].to(torch.float32) * (out[None] - xb)
    h_new = (hf.reshape(n, n, chunk) + delta).reshape(n, n * chunk)[:, :D]
    x_new = out.reshape(-1)[:D][None].expand(n, D)
    return (x_new.to(xl.dtype).reshape(xl.shape),
            h_new.to(hl.dtype).reshape(hl.shape))


def block_rs_aggregate(x, h, off: int, n: int, tcfg, eta: float, *,
                       impl: str = "auto", c: Optional[int] = None,
                       slot_of: Optional[torch.Tensor] = None,
                       down: Optional[torch.Tensor] = None,
                       arrived: Optional[torch.Tensor] = None,
                       correct: bool = True,
                       wire: Optional[str] = None, wire_seed: int = 0,
                       wire_down: bool = False, robust=None):
    """Aggregate client-stacked leaves (an ``(n, ...)`` tensor or a dict of
    them) under the blocked template; returns new ``(x, h)`` of the same
    structure: every DownCom'd row of x is the owner mean, and h moves on
    owned blocks only, so ``sum_i h_i`` stays 0 per coordinate.

    ``c``/``slot_of`` lay the ``c`` blocks over the cohort's slots
    (``slot_of[i]`` in ``[0, c)``, -1 idle; default full participation),
    ``down`` is the DownCom rows, ``arrived``/``correct`` the fault-tolerant
    inputs, ``wire``/``wire_seed``/``wire_down`` the quantized wire and
    ``robust`` the normalized combiner (``comm_ws.blocked_comm_leaves``).
    ``impl``: ``"ws"``/``"dense"`` the plain paths, ``"pallas"``/``"auto"``
    the kernel path over a packed f32 workspace."""
    scale = eta / tcfg.gamma
    kw = dict(down=down, arrived=arrived, correct=correct, wire=wire,
              wire_seed=wire_seed, wire_down=wire_down, robust=robust)
    if impl in comm_ws.COMM_IMPLS:
        return comm_ws.blocked_comm_leaves(x, h, off, n, tcfg.s, scale, impl,
                                           c=c, slot_of=slot_of, **kw)
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown comm impl {impl!r}")
    m = n if c is None else int(c)
    if slot_of is None:
        if m != n:
            raise ValueError(f"block_rs_aggregate with c={m} < n={n} needs "
                             "slot_of")
        slot_of = torch.arange(n)
    xs, hs = comm_ws._leaf_items(x), comm_ws._leaf_items(h)
    dev = xs[0][1].device
    specs = [(str(i), tuple(t.shape[1:])) for i, (_, t) in enumerate(xs)]
    spec = comm_ws.workspace_spec(specs)
    xw = torch.empty(n, spec.d_total, dtype=torch.float32, device=dev)
    hw = torch.empty_like(xw)
    comm_ws.pack({str(i): t for i, (_, t) in enumerate(xs)}, spec, xw)
    comm_ws.pack({str(i): t for i, (_, t) in enumerate(hs)}, spec, hw)
    band = comm_ws.block_band(spec.dims, m, dev)
    policy = wire if wire_mod.is_wire(wire) else None
    plan = comm_ws.wire_plan(spec.dims, policy, m, tcfg.s, band,
                             template="blocked")
    comm_ws.blocked_comm(
        xw, hw, int(off), torch.as_tensor(slot_of).to(dev), band, m, tcfg.s,
        scale, down=None if down is None else torch.as_tensor(down).to(
            device=dev, dtype=torch.int32),
        arrived=None if arrived is None else torch.as_tensor(arrived).to(
            device=dev, dtype=torch.bool),
        correct=correct, robust=robust, wire=plan, wire_seed=wire_seed,
        wire_down=bool(wire_down) and policy is not None)
    xo, ho = comm_ws.unpack(xw, spec), comm_ws.unpack(hw, spec)
    out_x = {k: xo[str(i)].to(t.dtype) for i, (k, t) in enumerate(xs)}
    out_h = {k: ho[str(i)].to(t.dtype) for i, (k, t) in enumerate(hs)}
    if isinstance(x, torch.Tensor):
        return out_x[None], out_h[None]
    return out_x, out_h
