"""Compression operators of TAMUNA (the port of ``repro.core.compression``).

* the permutation-mask compressor in its mask form (``apply_mask``,
  ``aggregate_masked``) for the templates the ``compress`` kernel does not
  compute (tall-and-thin and blocked; ``core/tamuna.py`` runs the cyclic
  template through the kernel),
* the unbiased per-chunk stochastic quantizer, with its uniform draws
  passed in,
* the uplink accounting,
* the cohort draw, from the port's own numpy stream keyed by
  ``(seed, COHORT_FOLD, round)`` (the reference draws it from a jax key;
  parity tests inject the reference's cohort).

Everything works on tensors of the caller's type and device; the convex
core passes float64.  ``rand_k``/``top_k`` serve only the baselines, which
are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import masks
from repro_torch.kernels.ref import _div

# stream tag of the cohort draw: SeedSequence([seed, COHORT_FOLD, r])
COHORT_FOLD = 0xC047


def apply_mask(v: torch.Tensor, q_col: torch.Tensor) -> torch.Tensor:
    """``C_i(v)``: elementwise multiply by the client's binary mask column."""
    return v * q_col.to(v.dtype)


def aggregate_masked(xs: torch.Tensor, q: torch.Tensor,
                     s: int) -> torch.Tensor:
    """Server aggregation ``x_bar = (1/s) sum_i C_i(x_i)`` (Algorithm 1
    l.12) over ``xs`` ``(c, d)`` with the ``(d, c)`` mask ``q``; exact at
    consensus (every coordinate has exactly ``s`` owners)."""
    return _div((xs * q.T.to(xs.dtype)).sum(dim=0), s)


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
