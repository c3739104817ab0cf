"""Byzantine-robust aggregation (``repro.dist.robust``).

``normalize_robust``
    config normalization with the reference's contract: ``mean`` and
    ``trimmed`` with ``k == 0`` normalize to ``None``, and the comm step
    takes ``robust=None`` to run the mean path unchanged, bitwise.

``robust_combine_stack``
    the combine the plain comm implementations call: the coordinate-wise
    trimmed mean or median over a stacked candidate axis with a validity
    mask, branch for branch the reference's (the static window of
    ``ok=None``, the sort-free fast path of ``trimmed`` k=1 and of small
    medians, the min/max sorting network up to 32 rows, a sort above), so
    each branch adds in the reference's order.

``payload_norms`` / ``masked_median`` / ``magnitude_outliers``
    the adaptive magnitude guard: per-client payload L2 norms over the
    ``(n, d_total)`` workspace (column chunks, the listed rows only, f32
    math whatever the storage type), flagged above ``median + nu * 1.4826
    * MAD`` of the masked norms with a 5%-of-median floor on the band.

``anomaly_scores`` / ``Reputation`` / ``recenter_h``
    the feedback loop: per-client distance to the coordinate-wise median
    of the arrived rows (column chunks over the workspace, never the whole
    stack), an EWMA reputation on the host that emits escalating
    quarantine windows, and the re-centering of the control variates over
    the clients still in play.

The workspace kernel path's robust combine is the ``robust_sum`` kernel
(``kernels/uplink.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import CHUNK  # columns per workspace pass
from repro_torch.kernels.ref import _div, column_chunks

__all__ = [
    "ROBUST_AGGS",
    "normalize_robust",
    "robust_combine_stack",
    "payload_norms",
    "masked_median",
    "magnitude_outliers",
    "anomaly_scores",
    "recenter_h",
    "Reputation",
]

ROBUST_AGGS = ("mean", "trimmed", "median")

# MAD -> sigma consistency constant for a normal population
_MAD_SIGMA = 1.4826


def normalize_robust(kind: str, k: int, s: int
                     ) -> Optional[Tuple[str, int]]:
    """Validate a robust-combiner spec and normalize it to what the comm
    step takes: ``None`` (the mean path, bitwise) or ``("trimmed", k)`` /
    ``("median", 0)``.  ``k`` values are trimmed per side; ``2 k < s``
    keeps at least one owner value at full arrival."""
    if kind not in ROBUST_AGGS:
        raise ValueError(
            f"unknown robust_agg {kind!r}; want one of {ROBUST_AGGS}")
    k = int(k)
    if k < 0:
        raise ValueError(f"trim_k={k} must be >= 0")
    if kind == "mean":
        if k:
            raise ValueError("robust_agg='mean' takes no trim_k")
        return None
    if kind == "median":
        if k:
            raise ValueError("robust_agg='median' takes no trim_k")
        return ("median", 0)
    if 2 * k >= int(s):
        raise ValueError(
            f"trimmed combiner needs 2*trim_k < s (k={k}, s={s}): "
            f"trimming would discard every owner value")
    if k == 0:
        return None  # the bitwise-mean contract
    return ("trimmed", k)


def _oem_pairs(m: int):
    """Batcher odd-even mergesort compare-exchange schedule for ``m``
    lanes (``robust._oem_pairs``)."""
    pairs = []
    p = 1
    while p < m:
        k = p
        while k >= 1:
            for j in range(k % p, m - k, 2 * k):
                for i in range(min(k, m - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


# above this stack height the reference sorts instead of running the
# network
_NETWORK_MAX = 32


def _min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's minimum: NaN propagates and -0 < +0 (``torch.minimum``
    returns its first argument on a tie of zeros)."""
    return torch.where(a == b, torch.where(torch.signbit(a), a, b),
                       torch.minimum(a, b))


def _max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's maximum: NaN propagates and +0 > -0."""
    return torch.where(a == b, torch.where(torch.signbit(a), b, a),
                       torch.maximum(a, b))


def _network(rows: list) -> list:
    """The rows sorted element-wise by the min/max network (a new list);
    min and max are exact, so the values are a sort's, and a zero's sign
    lands where the reference's network puts it."""
    rows = list(rows)
    for a, b in _oem_pairs(len(rows)):
        lo = _min(rows[a], rows[b])
        rows[b] = _max(rows[a], rows[b])
        rows[a] = lo
    return rows


def _sort_stack(v: torch.Tensor) -> torch.Tensor:
    """``v`` sorted along axis 0: the network up to ``_NETWORK_MAX``
    rows, ``torch.sort`` above (``robust._sort_stack``)."""
    if v.shape[0] > _NETWORK_MAX:
        return torch.sort(v, dim=0).values
    return torch.stack(_network(v.unbind(0)))


def robust_combine_stack(vals: torch.Tensor, ok, kind: str, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-wise robust combine over the stacked axis 0 of ``vals``
    (``robust.robust_combine_stack``): ``(x_bar, cnt)``, the trimmed mean
    (``k`` per side, fewer where the valid count is small) or the median
    per coordinate, 0 where no entry is valid, and the int32 valid count.

    ``ok`` (bool, broadcastable to ``vals``) marks the valid entries;
    ``None`` declares every entry valid statically (the window is fixed
    and the sorted rows are added in ascending order).  With a mask,
    invalid entries sort to ``+inf`` past the count; ``trimmed`` with
    k = 1 and medians of at most 4 rows take the reference's sort-free
    path, which sums the strict middle and adds the counted extremes back
    (no term cancels against an outlier)."""
    if kind not in ("trimmed", "median"):
        raise ValueError(f"robust_combine_stack kind {kind!r}")
    m = vals.shape[0]
    dt, dev = vals.dtype, vals.device
    zero = torch.zeros((), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    small = m <= _NETWORK_MAX
    if ok is None:
        if kind == "median":
            lo, hi = (m - 1) // 2, m // 2
        else:
            k_eff = min(max(k, 0), (m - 1) // 2)
            lo, hi = k_eff, m - k_eff - 1
        cnt = torch.full(vals.shape[1:], m, dtype=torch.int32, device=dev)
        den = torch.full((), hi - lo + 1, dtype=dt, device=dev)
        if small:
            # the reference's window sum: every row, +0 outside the window
            num = zero
            for i, r in enumerate(_network(vals.unbind(0))):
                num = num + (r if lo <= i <= hi else zero)
        else:
            num = _sort_stack(vals)[lo:hi + 1].sum(dim=0)
        return num / den, cnt
    ok = torch.broadcast_to(torch.as_tensor(ok, dtype=torch.bool,
                                            device=dev), vals.shape)
    if small:
        vrows, orows = vals.unbind(0), ok.unbind(0)
        cnt = orows[0].to(torch.int32)
        for o in orows[1:]:
            cnt = cnt + o.to(torch.int32)
    else:
        cnt = ok.sum(dim=0, dtype=torch.int32)
    if small and (kind == "trimmed" and k == 1
                  or kind == "median" and m <= 4):
        # the sort-free path: the strict middle summed in row order, the
        # surplus extremes added back by count
        mn = torch.where(orows[0], vrows[0], pinf)
        mx = torch.where(orows[0], vrows[0], -pinf)
        for v_, o_ in zip(vrows[1:], orows[1:]):
            mn = _min(mn, torch.where(o_, v_, pinf))
            mx = _max(mx, torch.where(o_, v_, -pinf))
        c_mn = torch.zeros((), dtype=torch.int32, device=dev)
        c_mx = torch.zeros((), dtype=torch.int32, device=dev)
        mid = zero
        for v_, o_ in zip(vrows, orows):
            c_mn = c_mn + (o_ & (v_ == mn)).to(torch.int32)
            c_mx = c_mx + (o_ & (v_ == mx)).to(torch.int32)
            mid = mid + torch.where(o_ & (v_ > mn) & (v_ < mx), v_, zero)
        trim = (cnt >= 3).to(torch.int32)
        keep_mn, keep_mx = c_mn - trim, c_mx - trim
        ext = (torch.where(keep_mn > 0, keep_mn.to(dt) * mn, zero)
               + torch.where(keep_mx > 0, keep_mx.to(dt) * mx, zero))
        kept = cnt - 2 * trim
        num = torch.where(mn == mx,
                          torch.where(kept > 0, kept.to(dt) * mn, zero),
                          mid + ext)
        den = torch.clamp(kept, min=1).to(dt)
        return torch.where(cnt > 0, num / den, zero), cnt
    safe = torch.clamp(cnt, min=1)
    if kind == "median":
        lo, hi = (safe - 1) // 2, safe // 2
    else:
        k_eff = torch.clamp(torch.clamp((cnt - 1) // 2, max=int(k)), min=0)
        lo, hi = k_eff, cnt - k_eff - 1
    if small:
        srows = _network([torch.where(o_, v_, pinf)
                          for v_, o_ in zip(vrows, orows)])
        num = zero
        for i, r in enumerate(srows):
            num = num + torch.where((lo <= i) & (i <= hi), r, zero)
    else:
        v = torch.sort(torch.where(ok, vals, pinf), dim=0).values
        idx = torch.arange(m, device=dev).reshape(
            (m,) + (1,) * (vals.ndim - 1))
        num = torch.where((idx >= lo[None]) & (idx <= hi[None]), v,
                          zero).sum(dim=0)
    den = torch.clamp(hi - lo + 1, min=1).to(dt)
    return torch.where(cnt > 0, num / den, zero), cnt


def payload_norms(ws: torch.Tensor, rows=None) -> torch.Tensor:
    """(n,) f32 CPU tensor of per-client payload L2 norms of the
    ``(n, d)`` workspace, for the ``rows`` (a ``(n,)`` bool mask; every
    row when ``None``; other entries 0), computed in f32 whatever the
    storage type.  A nonfinite entry counts as 1e30, whose square
    overflows, so a NaN/Inf row has norm inf."""
    n, d = ws.shape
    rows = np.ones(n, bool) if rows is None else np.asarray(rows, bool)
    out = torch.zeros(n, dtype=torch.float32)
    for i in np.flatnonzero(rows).tolist():
        tot = torch.zeros((), dtype=torch.float32, device=ws.device)
        for a in range(0, d, CHUNK):
            f = ws[i, a:a + CHUNK].to(torch.float32)
            f = torch.where(torch.isfinite(f), f, 1e30)
            tot = tot + (f * f).sum()
        out[i] = torch.sqrt(tot).cpu()
    return out


def masked_median(v: torch.Tensor, mask) -> torch.Tensor:
    """Median of ``v`` over the ``mask`` entries (0.0 when none)."""
    mask = torch.as_tensor(np.asarray(mask, bool))
    sv = torch.sort(torch.where(mask, v, float("inf"))).values
    cnt = int(mask.sum())
    if cnt == 0:
        return torch.zeros((), dtype=v.dtype)
    return 0.5 * (sv[(cnt - 1) // 2] + sv[cnt // 2])


def magnitude_outliers(ws: torch.Tensor, mask,
                       nu: float = 6.0) -> np.ndarray:
    """(n,) bool adaptive magnitude guard: ``mask``'ed clients whose
    payload norm exceeds ``median + nu * 1.4826 * MAD`` of the masked
    norms, the band floored at 5% of the median."""
    mask = np.asarray(mask, bool)
    return norm_outliers(payload_norms(ws, mask), mask, nu)


def norm_outliers(norms: torch.Tensor, mask, nu: float = 6.0) -> np.ndarray:
    """``magnitude_outliers`` from the ``(n,)`` f32 CPU payload norms of
    the ``mask``'ed clients (``payload_norms``; under data parallelism
    each rank's, summed)."""
    mask = np.asarray(mask, bool)
    med = masked_median(norms, mask)
    mad = masked_median(torch.abs(norms - med), mask)
    band = torch.maximum(nu * _MAD_SIGMA * mad, 0.05 * med)
    return mask & (norms > med + band).numpy()


# --------------------------------------------------------------------------
# anomaly scores + EWMA reputation -> quarantine windows
# --------------------------------------------------------------------------


def anomaly_scores(ws: torch.Tensor, mask) -> np.ndarray:
    """(n,) f32 per-client anomaly of the ``(n, d)`` workspace (any float
    storage type, f32 math): the L2 distance of each ``mask``'ed row to
    the coordinate-wise median of the ``mask``'ed rows, over the masked
    median distance floored at 5% of the median's norm (plus 1e-12); 0
    outside ``mask``.  Nonfinite entries count as 0.  Works in column
    chunks over the listed rows, so the stack is never whole."""
    n, d = ws.shape
    mask = np.asarray(mask, bool)
    rows = np.flatnonzero(mask).tolist()
    if not rows:
        return np.zeros(n, np.float32)
    dev = ws.device
    idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    d2 = torch.zeros(len(rows), dtype=torch.float32, device=dev)
    c2 = torch.zeros((), dtype=torch.float32, device=dev)
    m = len(rows)
    lo, hi = (m - 1) // 2, m // 2
    pairs = _oem_pairs(m)
    for cols in column_chunks(d):
        f = ws[:, cols].index_select(0, idx).to(torch.float32)
        f.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        # the reference's masked median over every row has the values of
        # the listed rows' middle order statistics, their sum halved: the
        # min/max network gives them (a zero's sign aside, which the
        # squares below do not see)
        srt = list(f.unbind(0))
        for a, b in pairs:
            srt[a], srt[b] = (torch.minimum(srt[a], srt[b]),
                              torch.maximum(srt[a], srt[b]))
        center = srt[lo] if lo == hi else _div(srt[lo] + srt[hi], 2)
        if m == 1:  # a view of f, which the next line overwrites
            center = center.clone()
        del srt
        d2 = d2 + f.sub_(center).square_().sum(dim=1)
        c2 = c2 + (center * center).sum()
        del f, center
    dist = torch.zeros(n, dtype=torch.float32)
    dist[rows] = torch.sqrt(d2).cpu()
    med = masked_median(dist, mask)
    floor = 0.05 * torch.sqrt(c2).cpu()
    out = torch.where(torch.as_tensor(mask),
                      dist / (torch.maximum(med, floor) + 1e-12),
                      torch.zeros((), dtype=torch.float32))
    return out.numpy()


def recenter_h(h: torch.Tensor, active) -> torch.Tensor:
    """``h_i - mean_active(h)`` on the ``active`` rows of the ``(n, ...)``
    control variates, the other rows untouched; a new tensor in ``h``'s
    type, the mean summed in row order and divided once
    (``robust.recenter_h``)."""
    active = np.asarray(active, bool)
    cnt = max(int(active.sum()), 1)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    tot = zero
    for i in range(h.shape[0]):
        tot = tot + (h[i] if active[i] else zero)
    mean = _div(tot, cnt)
    am = torch.as_tensor(active, device=h.device).reshape(
        (-1,) + (1,) * (h.ndim - 1))
    return torch.where(am, h - mean[None], h)


class Reputation:
    """Host-side EWMA reputation over per-round anomaly scores, emitting
    escalating quarantine windows (``robust.Reputation``, numpy only).

    ``update(anomaly, arrived)`` folds a round's (n,) anomaly row into the
    arrived clients' EWMAs and returns ``[(client, window_rounds), ...]``
    for every client whose EWMA crossed ``threshold``: window =
    ``base_rounds * 2**min(strikes, max_doublings)``; the strike counter
    increments and the EWMA resets.  ``state_dict``/``from_state_dict``
    round-trip everything."""

    def __init__(self, n: int, *, alpha: float = 0.5,
                 threshold: float = 3.0, base_rounds: int = 4,
                 max_doublings: int = 6):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha={alpha} outside (0, 1]")
        if threshold <= 1.0:
            raise ValueError(
                f"threshold={threshold} <= 1: honest clients score ~1")
        self.n = int(n)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.base_rounds = int(base_rounds)
        self.max_doublings = int(max_doublings)
        self.scores = np.zeros(self.n, np.float64)
        self.strikes = np.zeros(self.n, np.int64)

    def update(self, anomaly, arrived):
        an = np.asarray(anomaly, np.float64)
        arr = np.asarray(arrived, bool)
        a = self.alpha
        self.scores[arr] = (1.0 - a) * self.scores[arr] + a * an[arr]
        out = []
        for i in np.nonzero(arr & (self.scores > self.threshold))[0]:
            w = self.base_rounds * (
                2 ** min(int(self.strikes[i]), self.max_doublings))
            self.strikes[i] += 1
            self.scores[i] = 0.0
            out.append((int(i), int(w)))
        return out

    def state_dict(self) -> dict:
        return {
            "n": self.n, "alpha": self.alpha,
            "threshold": self.threshold,
            "base_rounds": self.base_rounds,
            "max_doublings": self.max_doublings,
            "scores": self.scores.tolist(),
            "strikes": self.strikes.tolist(),
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "Reputation":
        rep = cls(d["n"], alpha=d["alpha"], threshold=d["threshold"],
                  base_rounds=d["base_rounds"],
                  max_doublings=d["max_doublings"])
        rep.scores = np.asarray(d["scores"], np.float64).copy()
        rep.strikes = np.asarray(d["strikes"], np.int64).copy()
        return rep
