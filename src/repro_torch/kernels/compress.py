"""The TAMUNA ownership closed form (``repro.kernels.compress``).

``owned_from_band`` is the one ownership predicate of the comm path: the
plain versions in ``ref.py`` evaluate it here, and the CUDA kernels inline
its ``__device__`` twin of the same name in ``csrc/tamuna_kernels.cu``.
Integer ``%`` on torch tensors is the floor modulo of JAX and Python, which
the CUDA twin reproduces for negative operands.

``wire_dequant`` is the one definition of the int wire's dequantization,
and ``chunk_cols`` the scale column each coordinate of a kind group reads;
the dequantizing kernels compute both in the same way.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist.wire import CHUNK as WIRE_CHUNK, n_chunks


def owned_from_band(slot: torch.Tensor, band: torch.Tensor, m: int,
                    s: int) -> torch.Tensor:
    """Active slots in ``[0, m)`` own coordinate ``k`` iff
    ``(slot + band[k]) mod m < s``.  Shapes broadcast."""
    return (slot >= 0) & (slot < m) & (torch.remainder(slot + band, m) < s)


def cyclic_band(k: torch.Tensor, c: int, s: int) -> torch.Tensor:
    """The cyclic template's per-coordinate band: ``(-s k) mod c``."""
    return torch.remainder(-(s * torch.remainder(k, c)), c)


def wire_dequant(codes: torch.Tensor, scales: torch.Tensor,
                 chunk_ids: torch.Tensor) -> torch.Tensor:
    """Dequantize int-wire lanes: ``codes`` ``(rows, d)`` int8 times the
    per-chunk f32 scale that each column's ``chunk_ids`` entry selects from
    ``scales`` ``(rows, nchunk)``.  A NaN-poisoned scale yields NaN."""
    return codes.to(torch.float32) * scales[:, chunk_ids]


def chunk_offsets(leaf_lo: Sequence[int]) -> list:
    """``(L + 1,)`` scale-column offsets of a kind group whose leaves start
    at the group columns ``leaf_lo`` (``L + 1`` entries, the last the group
    width): the scales of leaf ``j`` are columns ``coff[j]:coff[j+1]``."""
    coff = [0]
    for a, b in zip(leaf_lo[:-1], leaf_lo[1:]):
        coff.append(coff[-1] + n_chunks(int(b) - int(a)))
    return coff


def chunk_cols(leaf_lo: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The scale column of group columns ``start:stop``: leaf ``j``'s
    coordinate ``k`` reads column ``coff[j] + k // 256`` (the chunk ids
    restart at every leaf, ``comm_ws._wire_chunkcol_np``).  ``leaf_lo`` is
    the ``(L + 1,)`` int64 table of leaf starts, on the output's device."""
    coff = torch.tensor(chunk_offsets(leaf_lo.tolist()), dtype=torch.int64,
                        device=leaf_lo.device)
    q = torch.arange(start, stop, dtype=torch.int64, device=leaf_lo.device)
    j = torch.searchsorted(leaf_lo, q, right=True) - 1
    return coff[j] + (q - leaf_lo[j]) // WIRE_CHUNK
