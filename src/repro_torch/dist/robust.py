"""Byzantine-robust aggregation, the part the round driver uses
(``repro.dist.robust``).

``normalize_robust``
    config normalization with the reference's contract: ``mean`` and
    ``trimmed`` with ``k == 0`` normalize to ``None``, and the comm step
    takes ``robust=None`` to run the mean path unchanged, bitwise.

``payload_norms`` / ``masked_median`` / ``magnitude_outliers``
    the adaptive magnitude guard: per-client payload L2 norms over the
    ``(n, d_total)`` workspace (column chunks, the listed rows only),
    flagged above ``median + nu * 1.4826 * MAD`` of the masked norms with
    a 5%-of-median floor on the band.

The robust combine itself is the ``robust_sum`` kernel
(``kernels/uplink.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import CHUNK  # columns per workspace pass

__all__ = [
    "ROBUST_AGGS",
    "normalize_robust",
    "payload_norms",
    "masked_median",
    "magnitude_outliers",
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


def payload_norms(ws: torch.Tensor, rows=None) -> torch.Tensor:
    """(n,) f32 CPU tensor of per-client payload L2 norms of the
    ``(n, d)`` workspace, for the ``rows`` (a ``(n,)`` bool mask; every
    row when ``None``; other entries 0).  A nonfinite entry counts as
    1e30, whose square overflows, so a NaN/Inf row has norm inf."""
    n, d = ws.shape
    rows = np.ones(n, bool) if rows is None else np.asarray(rows, bool)
    out = torch.zeros(n, dtype=torch.float32)
    for i in np.flatnonzero(rows).tolist():
        tot = torch.zeros((), dtype=torch.float32, device=ws.device)
        for a in range(0, d, CHUNK):
            f = ws[i, a:a + CHUNK]
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
    norms = payload_norms(ws, mask)
    med = masked_median(norms, mask)
    mad = masked_median(torch.abs(norms - med), mask)
    band = torch.maximum(nu * _MAD_SIGMA * mad, 0.05 * med)
    return mask & (norms > med + band).numpy()
