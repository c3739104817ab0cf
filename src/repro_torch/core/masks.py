"""Permutation-based compression masks (copied from ``repro.core.masks``).

The uplink compressor C_i keeps the coordinates of column ``i`` of a mask
``q in {0,1}^{d x c}``: a uniformly random column permutation of a fixed
template with exactly ``s`` ones in every row (every coordinate is
uploaded by exactly ``s`` of the ``c`` active clients) and ``floor(s d /
c)`` or ``ceil(s d / c)`` ones in every column.  Three templates:

* cyclic (``d s >= c``): row ``k`` has ones at columns ``mod(s k + t, c)``,
  ``t = 0..s-1``; the CUDA kernel ``compress`` evaluates this one in place;
* tall-and-thin (``d s < c``): column ``j < d s`` has its one at row
  ``mod(j, d)``, columns ``j >= d s`` are empty;
* blocked: ``c`` contiguous chunks of ``ceil(d / c)`` coordinates, chunk
  ``j`` owned by columns ``j .. j + s - 1 (mod c)``.

The templates are numpy, as in the reference; ``mask_from_permutation``
is torch.  The round's permutation is a draw from the port's own numpy
stream keyed by ``(seed, PERM_FOLD, round)`` (the reference draws it from
a jax key; parity tests inject the reference's permutation).
"""

from __future__ import annotations

import numpy as np
import torch

# stream tag of the round permutation: SeedSequence([seed, PERM_FOLD, r])
PERM_FOLD = 0x9E41


def _validate(d: int, c: int, s: int) -> None:
    if not (2 <= s <= c):
        raise ValueError(f"need 2 <= s <= c, got s={s}, c={c}")
    if d < 1:
        raise ValueError(f"need d >= 1, got d={d}")


def template_mask(d: int, c: int, s: int) -> np.ndarray:
    """Dense ``{0,1}^{d x c}`` template pattern of paper Fig. 1 (numpy)."""
    _validate(d, c, s)
    q = np.zeros((d, c), dtype=np.int8)
    if d * s >= c:
        # cyclic band: row k owns columns mod(s k + t, c), t in [0, s)
        for k in range(d):
            for t in range(s):
                q[k, (s * k + t) % c] = 1
    else:
        # tall-and-thin regime: column j < d s has one at row mod(j, d)
        for j in range(d * s):
            q[j % d, j] = 1
    return q


def block_template_mask(d: int, c: int, s: int) -> np.ndarray:
    """Contiguous-block template: chunk ``j`` of ``ceil(d/c)`` coordinates
    (last chunk ragged) is owned by columns ``j .. j+s-1 (mod c)``."""
    _validate(d, c, s)
    q = np.zeros((d, c), dtype=np.int8)
    chunk = -(-d // c)  # ceil
    for k in range(d):
        j = min(k // chunk, c - 1)
        for t in range(s):
            q[k, (j + t) % c] = 1
    return q


def sample_permutation(seed: int, r: int, c: int) -> np.ndarray:
    """Uniformly random permutation of ``[c]`` for round ``r``, from the
    numpy stream ``SeedSequence([seed, PERM_FOLD, r])``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, PERM_FOLD, r]))
    return rng.permutation(c)


def mask_from_permutation(perm: torch.Tensor, d: int, c: int, s: int, *,
                          blocked: bool = False) -> torch.Tensor:
    """Dense mask ``q[:, i] = template[:, perm[i]]``, ``(d, c)`` int8 on
    ``perm``'s device, from the closed forms (no template is built)."""
    _validate(d, c, s)
    cols = perm.to(torch.int64)[None, :]
    k = torch.arange(d, dtype=torch.int64, device=perm.device)[:, None]
    if blocked:
        chunk = -(-d // c)
        j = torch.clamp(k // chunk, max=c - 1)
        q = torch.remainder(cols - j, c) < s
    elif d * s >= c:
        q = torch.remainder(cols - s * k, c) < s
    else:
        q = (cols < d * s) & (torch.remainder(cols, d) == k)
    return q.to(torch.int8)


def block_shift_permutation(off: int, c: int, s: int,
                            device="cpu") -> torch.Tensor:
    """The column permutation ``(a + off + s - 1) mod c`` that realizes the
    dist engine's shifted blocked ownership (slot ``a`` owns blocks
    ``a + off .. a + off + s - 1``) as a column permutation of the block
    template, whose column ``p`` owns blocks ``p - s + 1 .. p``."""
    return torch.remainder(
        torch.arange(c, dtype=torch.int32, device=device) + off + s - 1, c)


def sample_mask(seed: int, r: int, d: int, c: int, s: int, *,
                blocked: bool = False, device="cpu") -> torch.Tensor:
    """The round mask ``q`` of round ``r`` (paper Fig. 1(c))."""
    perm = torch.from_numpy(sample_permutation(seed, r, c)).to(device)
    return mask_from_permutation(perm, d, c, s, blocked=blocked)


def column_nnz(d: int, c: int, s: int) -> int:
    """Worst-case uploaded floats per client: ``ceil(s d / c)`` (or 1)."""
    return max(1, -(-s * d // c))


def block_column_nnz(d: int, c: int, s: int) -> int:
    """Worst-case uploaded floats per client under the blocked template:
    ``s`` chunks of ``ceil(d/c)`` coordinates, capped at ``d``."""
    return min(d, s * -(-d // c))


def owner_band_start(k, d: int, c: int, s: int):
    """Start of the cyclic owner band of coordinate ``k`` (``d s >= c``):
    ``k`` is owned by template columns ``mod(s k + t, c), t in [0, s)``."""
    del d
    return (s * k) % c
