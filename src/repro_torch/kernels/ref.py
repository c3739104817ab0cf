"""Plain PyTorch versions of the CUDA kernels of the training round.

They are the kernels' oracles: the wrappers run them for CPU tensors, the
CPU tests hold them against the reference's Pallas kernels in interpret
mode, and ``chip_smoke.py`` holds each kernel against them on the card.
Each repeats its kernel's arithmetic operation for operation (the client
rows are summed in row order, the products are not contracted into FMAs),
so a kernel and its plain version agree bitwise on the same inputs.

Ownership selects and never multiplies: idle and dropped rows may hold
anything, NaN included, and never reach an output.

The versions that make ``(n, d)``-shaped temporaries (ownership masks,
order-statistic buffers, the h update) work in column chunks of ``CHUNK``
coordinates, so they run at full width beside a full-size state.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels.compress import owned_from_band

CHUNK = 1 << 24  # columns per chunk of the chunked plain versions


def _chunks(d: int) -> Iterator[slice]:
    for a in range(0, d, CHUNK):
        yield slice(a, min(a + CHUNK, d))


def masked_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int) -> torch.Tensor:
    """UpCom with the exact rebuild: ``x_bar[k] = sum_{i owns k} x[i, k] / s``
    over the ``(n, d)`` workspace, rows added in order."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        owned = owned_from_band(slot[i], band, m, s)
        acc = acc + torch.where(owned, x[i], 0.0)
    return acc / s


def masked_sum_counts(x: torch.Tensor, slot: torch.Tensor,
                      band: torch.Tensor, m: int,
                      s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survivor UpCom: the raw owner sum ``num[k] = sum_{i owns k} x[i, k]``
    (rows added in order, no ``1/s``) and the f32 owner count ``cnt[k]``."""
    d = x.shape[1]
    num = torch.empty(d, dtype=torch.float32, device=x.device)
    cnt = torch.empty(d, dtype=torch.float32, device=x.device)
    for cols in _chunks(d):
        acc = torch.zeros_like(num[cols])
        c = torch.zeros_like(cnt[cols])
        for i in range(x.shape[0]):
            owned = owned_from_band(slot[i], band[cols], m, s)
            acc = acc + torch.where(owned, x[i, cols], 0.0)
            c = c + owned.to(torch.float32)
        num[cols], cnt[cols] = acc, c
    return num, cnt


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
    for cols in _chunks(d):
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
    for cols in _chunks(d):
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
