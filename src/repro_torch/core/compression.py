"""Compression operators of TAMUNA (the port of ``repro.core.compression``).

* the permutation-mask compressor in its mask form (``apply_mask``,
  ``aggregate_masked``) for the templates the ``compress`` kernel does not
  compute (tall-and-thin and blocked; ``core/tamuna.py`` runs the cyclic
  template through the kernel),
* the unbiased per-chunk stochastic quantizer, with its uniform draws
  passed in,
* the unbiased ``rand_k`` and the biased ``top_k`` sparsifiers of the
  baselines (DIANA, EF21), on the last axis of any batch of vectors,
* the uplink accounting,
* the cohort and rand-k index draws, from the port's own numpy streams
  keyed by ``(seed, fold, round)`` (the reference draws them from jax
  keys; parity tests inject the reference's).

Everything works on tensors of the caller's type and device; the convex
core passes float64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import masks
from repro_torch.kernels.ref import _div

# stream tags: SeedSequence([seed, COHORT_FOLD, r]) draws the cohort,
# SeedSequence([seed, RANDK_FOLD, r]) the rand-k indices
COHORT_FOLD = 0xC047
RANDK_FOLD = 0x52AD


def apply_mask(v: torch.Tensor, q_col: torch.Tensor) -> torch.Tensor:
    """``C_i(v)``: elementwise multiply by the client's binary mask column."""
    return v * q_col.to(v.dtype)


def aggregate_masked(xs: torch.Tensor, q: torch.Tensor,
                     s: int) -> torch.Tensor:
    """Server aggregation ``x_bar = (1/s) sum_i C_i(x_i)`` (Algorithm 1
    l.12) over ``xs`` ``(c, d)`` with the ``(d, c)`` mask ``q``; exact at
    consensus (every coordinate has exactly ``s`` owners)."""
    return _div((xs * q.T.to(xs.dtype)).sum(dim=0), s)


def rand_k_indices(seed: int, r: int, d: int, k: int,
                   rows: int = 1) -> np.ndarray:
    """``(rows, k)`` int64: for each row, ``k`` distinct uniform
    coordinates of ``[d]`` for round ``r``, from ``SeedSequence([seed,
    RANDK_FOLD, r])``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, RANDK_FOLD,
                                                        r]))
    return np.stack([rng.choice(d, size=k, replace=False)
                     for _ in range(rows)]).astype(np.int64)


def rand_k(v: torch.Tensor, k: int, idx=None, *, seed: int = 0,
           r: int = 0) -> torch.Tensor:
    """Unbiased rand-k of each vector on the last axis of ``v``: keep
    ``k`` coordinates, scaled by ``d/k``, zero the rest
    (``E[rand_k(v)] = v``).  ``idx`` (``v.shape[:-1] + (k,)`` distinct
    coordinates per vector) is the draw; ``None`` draws it from
    ``rand_k_indices(seed, r, ...)``."""
    d = v.shape[-1]
    lead = v.shape[:-1]
    if idx is None:
        rows = int(np.prod(lead)) if lead else 1
        idx = rand_k_indices(seed, r, d, k, rows).reshape(lead + (k,))
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                          device=v.device).reshape(lead + (k,))
    if idx.shape[-1] != k:
        raise ValueError(f"rand_k wants {k} indices per vector")
    out = torch.zeros_like(v)
    return out.scatter_(-1, idx, v.gather(-1, idx) * (d / k))


def top_k(v: torch.Tensor, k: int) -> torch.Tensor:
    """Biased top-k of each vector on the last axis of ``v``: keep the
    ``k`` largest magnitudes, zero the rest.  Of equal magnitudes the
    lower index is kept first, as ``jax.lax.top_k`` keeps it."""
    idx = torch.sort(v.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.zeros_like(v).scatter_(-1, idx, v.gather(-1, idx))


def quantize_stochastic(v: torch.Tensor, bits: int, rnd: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    """Unbiased stochastic rounding of ``v`` (``(..., d)``) to ``bits`` bits
    with one scale per ``chunk`` coordinates; ``rnd`` holds the uniform
    draws in ``[0, 1)``, one per entry.  Nonfinite entries are left out of
    the chunk max and pass through untouched."""
    levels = 2 ** (bits - 1) - 1
    d = v.shape[-1]
    nc = -(-d // chunk)
    finite = torch.isfinite(v)
    a = torch.where(finite, v.abs(), torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
    pad = nc * chunk - d
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    mx = a.reshape(v.shape[:-1] + (nc, chunk)).amax(dim=-1)
    scale = torch.clamp(_div(mx, levels), min=1e-12)
    sc = scale.repeat_interleave(chunk, dim=-1)[..., :d]
    z = v / sc
    low = torch.floor(z)
    q = low + (rnd < z - low).to(v.dtype)
    return torch.where(finite, q * sc, v)


def uplink_floats_permutation(d: int, c: int, s: int) -> int:
    """Floats uploaded per client per round under the permutation mask."""
    return masks.column_nnz(d, c, s)


def uplink_floats_rand_k(k: int) -> int:
    return k


# wire widths in bytes (repro.dist.wire.WIDTH_BYTES) and the scale chunk
_WIRE_WIDTH_BYTES = {
    "f32": 4.0, "bf16": 2.0, "f16": 2.0, "int8": 1.0, "int4": 0.5,
}
_WIRE_CHUNK = 256


def uplink_bytes_permutation(d: int, c: int, s: int,
                             kind: str = "f32") -> float:
    """Wire bytes uploaded per client per round under the permutation mask
    at wire kind ``kind``; int kinds add the per-chunk f32 scales."""
    b = uplink_floats_permutation(d, c, s) * _WIRE_WIDTH_BYTES[kind]
    if kind in ("int8", "int4"):
        b += (-(-d // _WIRE_CHUNK)) * 4.0
    return float(b)


def uplink_bytes_rand_k(k: int, kind: str = "f32") -> float:
    """rand-k value payload at wire width ``kind``."""
    return float(k * _WIRE_WIDTH_BYTES[kind])


def split_cohort(seed: int, r: int, n: int,
                 c: int) -> Tuple[np.ndarray, np.ndarray]:
    """The active cohort of round ``r`` (``c`` of ``n``, uniform, without
    replacement) from ``SeedSequence([seed, COHORT_FOLD, r])``; returns
    ``(cohort_idx (c,), member_mask (n,))`` as numpy arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, COHORT_FOLD,
                                                        r]))
    idx = rng.choice(n, size=c, replace=False)
    member = np.zeros(n, dtype=bool)
    member[idx] = True
    return idx, member
