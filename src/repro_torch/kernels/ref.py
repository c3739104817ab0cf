"""Plain PyTorch versions of the CUDA kernels of the training round, of
the convex core's compressor (``compress``) and of decode attention.

They are the kernels' oracles: the wrappers run them for CPU tensors, the
CPU tests hold them against the reference's Pallas kernels in interpret
mode, and ``chip_smoke.py`` holds each kernel against them on the card.
Each repeats its kernel's arithmetic operation for operation (the client
rows are summed in row order, the products are not contracted into FMAs),
so a kernel and its plain version agree bitwise on the same inputs.

A division by a constant divides by a tensor on the operand's device
(``_div``): PyTorch's CUDA division by a Python number multiplies by its
reciprocal, one rounding away from the kernels' (and the CPU's) IEEE
division.

Ownership selects and never multiplies: idle and dropped rows may hold
anything, NaN included, and never reach an output.

The versions that make ``(n, d)``-shaped temporaries (ownership masks,
order-statistic buffers, the h update, the wire) work in column chunks of
``CHUNK`` coordinates, so they run at full width beside a full-size state.

``decode_attention`` is the serving side's: single-query GQA attention
over a KV cache (``repro.kernels.ref.decode_attention_ref``), one-shot f32
softmax; its kernel's online softmax adds in another order, so the two
agree to f32 rounding, not bitwise.

The UpComs take f32, bf16 or f16 lanes (cast to f32 exactly, then summed
in f32) or int8 wire codes with their per-chunk scales
(``masked_sum_dequant``).  The wire quantizer's plain versions are
``wire_pack`` (the UpCom codes and scales, ``wire.leaf_scales`` then
``wire.quantize_to_int``) and ``wire_down`` (the DownCom, ``wire.quantize``
on one row with row id ``wire.DOWN_ROW``); a kind group's leaves are given
as ``(leaf index, workspace offset, size)`` triples.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.dist import wire
from repro_torch.kernels.compress import (chunk_cols, cyclic_band,
                                          owned_from_band, wire_dequant)

# columns per chunk of the chunked plain versions; a multiple of the wire's
# 256-coordinate scale chunk, so a column chunk holds whole scale chunks
CHUNK = 1 << 24


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, on the CPU and on the card alike."""
    return a / torch.full((), float(b), dtype=a.dtype, device=a.device)


def column_chunks(d: int) -> Iterator[slice]:
    for a in range(0, d, CHUNK):
        yield slice(a, min(a + CHUNK, d))


def compress(x: torch.Tensor, slot: torch.Tensor, c: int,
             s: int) -> torch.Tensor:
    """C_i(x) under the cyclic template: ``(d,)`` with ``slot`` ``(1,)`` or
    ``(n, d)`` with ``slot`` ``(n,)``; row ``i`` keeps coordinate ``k``
    where ``slot[i]`` owns it (band ``(-s (k mod c)) mod c``), else 0, and
    a slot outside ``[0, c)`` gives a zero row.  Selects, never multiplies;
    any float type."""
    rows = x.reshape(-1, x.shape[-1])
    sl = slot.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.empty_like(rows)
    for cols in column_chunks(rows.shape[1]):
        k = torch.arange(cols.start, cols.stop, dtype=torch.int64,
                         device=x.device)
        owned = owned_from_band(sl, cyclic_band(k, c, s)[None, :], c, s)
        out[:, cols] = torch.where(owned, rows[:, cols], zero)
    return out.reshape(x.shape)


def masked_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int) -> torch.Tensor:
    """UpCom with the exact rebuild: ``x_bar[k] = sum_{i owns k} x[i, k] / s``
    over the ``(n, d)`` workspace, rows added in order."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        owned = owned_from_band(slot[i], band, m, s)
        acc = acc + torch.where(owned, x[i].to(torch.float32), 0.0)
    return _div(acc, s)


def masked_sum_counts(x: torch.Tensor, slot: torch.Tensor,
                      band: torch.Tensor, m: int,
                      s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survivor UpCom: the raw owner sum ``num[k] = sum_{i owns k} x[i, k]``
    (rows added in order, no ``1/s``) and the f32 owner count ``cnt[k]``."""
    d = x.shape[1]
    num = torch.empty(d, dtype=torch.float32, device=x.device)
    cnt = torch.empty(d, dtype=torch.float32, device=x.device)
    for cols in column_chunks(d):
        acc = torch.zeros_like(num[cols])
        c = torch.zeros_like(cnt[cols])
        for i in range(x.shape[0]):
            owned = owned_from_band(slot[i], band[cols], m, s)
            acc = acc + torch.where(owned, x[i, cols].to(torch.float32),
                                    0.0)
            c = c + owned.to(torch.float32)
        num[cols], cnt[cols] = acc, c
    return num, cnt


def masked_sum_dequant(codes: torch.Tensor, scales: torch.Tensor,
                       leaf_lo: torch.Tensor, slot: torch.Tensor,
                       band: torch.Tensor, m: int, s: int,
                       counts: bool = False,
                       chunk_col: Optional[torch.Tensor] = None):
    """``masked_sum`` (``counts=True``: ``masked_sum_counts``) over int
    wire lanes: each owned code is dequantized against its row's chunk
    scale (``wire_dequant`` at ``chunk_cols(leaf_lo)``, or at the given
    per-column ``chunk_col``) and summed in f32 in row order.  A row that
    does not own a coordinate adds 0, whatever its scale."""
    n, d = codes.shape
    num = torch.empty(d, dtype=torch.float32, device=codes.device)
    cnt = torch.empty(d, dtype=torch.float32, device=codes.device)
    for cols in column_chunks(d):
        v = wire_dequant(codes[:, cols], scales,
                         chunk_cols(leaf_lo, cols.start, cols.stop)
                         if chunk_col is None
                         else chunk_col[cols].to(torch.int64))
        acc = torch.zeros_like(num[cols])
        c = torch.zeros_like(cnt[cols])
        for i in range(n):
            owned = owned_from_band(slot[i], band[cols], m, s)
            acc = acc + torch.where(owned, v[i], 0.0)
            c = c + owned.to(torch.float32)
        num[cols], cnt[cols] = acc, c
    if counts:
        return num, cnt
    return _div(num, s)


def _order_stats(x: torch.Tensor, owned: torch.Tensor, s: int
                 ) -> torch.Tensor:
    """``(s, C)``: the ``s`` smallest owned values of each column in
    ascending order, ``+inf`` past the owner count, all NaN where an owned
    value is NaN (what the Pallas body's ``s`` masked-min passes yield).
    Each owned value is inserted after every buffered value ``<=`` it, in
    row order, as the kernel does."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    buf = inf.expand(s, x.shape[1]).clone()
    any_nan = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    for i in range(x.shape[0]):
        v = x[i]
        nan = v.isnan()
        any_nan |= owned[i] & nan
        ins = owned[i] & ~nan
        for t in range(s - 1, -1, -1):  # top-down: buf[t - 1] still old
            if t > 0:
                new = torch.where(buf[t - 1] > v, buf[t - 1], v)
            else:
                new = v
            buf[t] = torch.where(ins & ~(buf[t] <= v), new, buf[t])
    return buf.masked_fill_(any_nan, float("nan"))


def robust_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int, kind: str,
               k: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Byzantine-robust UpCom: per coordinate the mean of the owned values
    with ``k`` trimmed off each side (``kind="trimmed"``; fewer where the
    owner count is small) or their median, 0 where no row owns the
    coordinate; returns ``(x_bar, cnt)`` with the f32 owner count."""
    d = x.shape[1]
    bar = torch.empty(d, dtype=torch.float32, device=x.device)
    cnt_out = torch.empty(d, dtype=torch.float32, device=x.device)
    for cols in column_chunks(d):
        xc = x[:, cols]
        owned = owned_from_band(slot[:, None], band[None, cols], m, s)
        cnt = owned.sum(dim=0, dtype=torch.int32)
        order = _order_stats(xc, owned, s)
        zero = torch.zeros_like(order[0])
        if kind == "median":
            loi = torch.clamp((cnt - 1) // 2, min=0)
            hii = cnt // 2
            lo, hi = zero, zero
            for t in range(s):
                lo = torch.where(loi == t, order[t], lo)
                hi = torch.where(hii == t, order[t], hi)
            b = 0.5 * (lo + hi)
        else:
            k_eff = torch.clamp(torch.minimum(
                torch.full_like(cnt, int(k)), (cnt - 1) // 2), min=0)
            num = zero
            for t in range(s):
                use = (t >= k_eff) & (t < cnt - k_eff)
                num = num + torch.where(use, order[t], zero)
            b = num / torch.clamp(cnt - 2 * k_eff, min=1).to(torch.float32)
        bar[cols] = torch.where(cnt > 0, b, zero)
        cnt_out[cols] = cnt.to(torch.float32)
    return bar, cnt_out


def h_update(x: torch.Tensor, h: torch.Tensor, x_bar: torch.Tensor,
             slot: torch.Tensor, band: torch.Tensor, m: int, s: int,
             scale: float, down: Optional[torch.Tensor] = None,
             covered: Optional[torch.Tensor] = None) -> None:
    """In place: ``h += scale * (x_bar - x)`` on owned coordinates (h on
    unowned coordinates is not written), then the DownCom ``x = x_bar`` on
    the ``down`` rows (every row when ``None``); other rows of ``x`` are
    not written.  ``covered`` (``(d,)`` bool) gates both updates per
    coordinate: uncovered coordinates keep h and x untouched."""
    n, d = x.shape
    rows = range(n) if down is None else down.nonzero()[:, 0].tolist()
    for cols in column_chunks(d):
        gate = None if covered is None else covered[cols]
        for i in range(n):
            owned = owned_from_band(slot[i], band[cols], m, s)
            if gate is not None:
                owned = owned & gate
            hr, xr = h[i, cols], x[i, cols]
            hr.copy_(torch.where(owned, hr + scale * (x_bar[cols] - xr), hr))
        for i in rows:
            if gate is None:
                x[i, cols] = x_bar[cols]
            else:
                x[i, cols] = torch.where(gate, x_bar[cols], x[i, cols])


def fused_local_step(x: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     gamma: float) -> torch.Tensor:
    """The TAMUNA local step ``x - gamma * (g - h)`` in f32."""
    return x - gamma * (g - h)


def _at_leaves(leaves, gdims):
    """``(leaf index, offset, size, group column, first scale column,
    global size)`` of the coordinate form's leaves."""
    g0 = c0 = 0
    for (li, o, D), G in zip(leaves, gdims):
        yield li, o, D, g0, c0, G
        g0 += D
        c0 += wire.n_chunks(G)


def wire_pack(x: torch.Tensor, leaves: Sequence[Tuple[int, int, int]],
              kind: str, seed: int, row0: int = 0, *,
              coords: Optional[torch.Tensor] = None,
              scales: Optional[torch.Tensor] = None,
              gdims: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int wire payload of a kind group: ``(codes (n, d_g) int8,
    scales (n, nc_g) f32)`` of the leaves ``(leaf index, offset, size)`` of
    the ``(n, d_total)`` f32 workspace ``x``, concatenated in the given
    order.  Leaf ``li`` draws with ``wire.fold_seed(seed, li)``, row ``i``
    with row id ``row0 + i``, coordinate ``k`` of the leaf with id ``k``;
    the result is ``wire.leaf_scales`` then ``wire.quantize_to_int``.

    The coordinate form (the blocks of model-sharded leaves): group column
    ``j`` is the leaf coordinate ``coords[j]``, which keys its draw and
    picks its scale among ``scales`` (leaf ``j``'s global chunks after the
    previous leaves', ``gdims`` the global sizes); the scales come back
    poisoned by the rows' nonfinite values (``wire.quantize_to_int``)."""
    n = x.shape[0]
    if coords is not None:
        codes = torch.empty(n, coords.shape[0], dtype=torch.int8,
                            device=x.device)
        out = scales.clone()
        rows = torch.arange(row0, row0 + n, dtype=torch.int64,
                            device=x.device)[:, None]
        for li, o, D, g0, c0, G in _at_leaves(leaves, gdims):
            sl = wire.fold_seed(seed, li)
            blk = slice(c0, c0 + wire.n_chunks(G))
            for cols in column_chunks(D):
                kk = coords[g0 + cols.start:g0 + cols.stop]
                q, sc = wire.quantize_to_int(
                    x[:, o + cols.start:o + cols.stop], kind, sl, rows, kk,
                    scales[:, blk], kk // wire.CHUNK)
                codes[:, g0 + cols.start:g0 + cols.stop] = q
                out[:, blk] = torch.where(sc.isnan(), sc, out[:, blk])
        return codes, out
    d_g = sum(D for _, _, D in leaves)
    nc_g = sum(wire.n_chunks(D) for _, _, D in leaves)
    codes = torch.empty(n, d_g, dtype=torch.int8, device=x.device)
    scales = torch.empty(n, nc_g, dtype=torch.float32, device=x.device)
    rows = torch.arange(row0, row0 + n, dtype=torch.int64,
                        device=x.device)[:, None]
    g0 = c0 = 0
    for li, o, D in leaves:
        sl = wire.fold_seed(seed, li)
        for cols in column_chunks(D):
            xc = x[:, o + cols.start:o + cols.stop]
            kk = torch.arange(cols.start, cols.stop, dtype=torch.int64,
                              device=x.device)
            sc = wire.leaf_scales(xc, kind)
            q, sc = wire.quantize_to_int(xc, kind, sl, rows, kk, sc,
                                         (kk - cols.start) // wire.CHUNK)
            codes[:, g0 + cols.start:g0 + cols.stop] = q
            a = c0 + cols.start // wire.CHUNK
            scales[:, a:a + sc.shape[1]] = sc
        g0 += D
        c0 += wire.n_chunks(D)
    return codes, scales


def wire_down(x_bar: torch.Tensor, leaves: Sequence[Tuple[int, int, int]],
              kind: str, seed: int, *,
              coords: Optional[torch.Tensor] = None,
              scales: Optional[torch.Tensor] = None,
              gdims: Optional[Sequence[int]] = None) -> None:
    """The DownCom quantizer, in place on the ``(d_total,)`` f32 ``x_bar``:
    each leaf ``(leaf index, offset, size)`` becomes ``wire.quantize`` of
    it as one row with row id ``wire.DOWN_ROW`` (nonfinite values pass
    through, scales are not poisoned).  ``coords``, ``scales`` ``(1,
    nc_g)`` and ``gdims``: ``wire_pack``'s coordinate form."""
    if coords is not None:
        for li, o, D, g0, c0, G in _at_leaves(leaves, gdims):
            sl = wire.fold_seed(seed, li)
            for cols in column_chunks(D):
                seg = x_bar[o + cols.start:o + cols.stop]
                kk = coords[g0 + cols.start:g0 + cols.stop]
                seg.copy_(wire.quantize(
                    seg[None], kind, sl, wire.DOWN_ROW, kk,
                    scales[:, c0:c0 + wire.n_chunks(G)],
                    kk // wire.CHUNK)[0])
        return
    for li, o, D in leaves:
        sl = wire.fold_seed(seed, li)
        for cols in column_chunks(D):
            seg = x_bar[o + cols.start:o + cols.stop]
            kk = torch.arange(cols.start, cols.stop, dtype=torch.int64,
                              device=x_bar.device)
            seg.copy_(wire.quantize(seg[None], kind, sl, wire.DOWN_ROW,
                                    kk)[0])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-query GQA decode attention over a KV cache: ``q (b, h, hd)``
    against ``k, v (b, S, kvh, hd)`` (any float type, widened exactly),
    keys ``pos - window < t <= pos`` visible, query head ``j`` on kv head
    ``j // (h // kvh)``.  Logits ``(q . k) / sqrt(hd)`` and the softmax in
    f32, ``softcap * tanh(logits / softcap)``, masked logits -1e30; the
    output in ``q``'s dtype."""
    b, h, hd = q.shape
    S, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, hd).float()
    logits = _div(torch.einsum("bkgd,bskd->bkgs", qg, k.float()),
                  math.sqrt(hd))
    if softcap is not None:
        logits = softcap * torch.tanh(_div(logits, softcap))
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)
