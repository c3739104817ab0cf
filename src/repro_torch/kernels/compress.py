"""The TAMUNA ownership closed form (``repro.kernels.compress``).

``owned_from_band`` is the one ownership predicate of the comm path: the
plain versions in ``ref.py`` evaluate it here, and the CUDA kernels inline
its ``__device__`` twin of the same name in ``csrc/tamuna_kernels.cu``.
Integer ``%`` on torch tensors is the floor modulo of JAX and Python, which
the CUDA twin reproduces for negative operands.

``wire_dequant`` is the one definition of the int wire's dequantization,
and ``chunk_cols`` the scale column each coordinate of a kind group reads;
the dequantizing kernels compute both in the same way.

``compress`` is C_i(x), the convex core's permutation-mask compressor under
the cyclic template.  It replaces the Pallas ``repro.kernels.compress.
compress`` (``_compress2d_kernel``, compress.py:71, for ``(n, d)`` with one
slot per row; ``_compress_kernel``, compress.py:63, for ``(d,)`` with one
slot), reached from the UpCom and the control-variate update of
``core/tamuna.round_step``.  It must read the owned entries (``s/c`` of
each active row) and write every output once: (owned + n d) x the width
in bytes, on one H100 at 3.35 TB/s, bound by bytes.  A CPU tensor runs the
plain version ``ref.compress``; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.dist.wire import CHUNK as WIRE_CHUNK, n_chunks
from repro_torch.kernels import _build

# the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.float64: 1}


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


def compress(x: torch.Tensor, slot: torch.Tensor, c: int,
             s: int) -> torch.Tensor:
    """C_i(x): ``(d,)`` with ``slot`` ``(1,)``, or ``(n, d)`` with ``slot``
    ``(n,)``, f32 or f64, contiguous; ``slot`` int32 on ``x``'s device.
    Row ``i`` keeps the coordinates that ``slot[i]`` owns under the cyclic
    template and is 0 elsewhere; a slot outside ``[0, c)`` gives a zero
    row.  Returns a new tensor."""
    if not 1 <= s <= c:
        raise ValueError(f"need 1 <= s <= c, got s={s} c={c}")
    if (x.dim() not in (1, 2) or x.dtype not in _DTYPES
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous (d,) or (n, d) f32 or f64 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    n = 1 if x.dim() == 1 else x.shape[0]
    if (tuple(slot.shape) != (n,) or slot.dtype != torch.int32
            or not slot.is_contiguous() or slot.device != x.device):
        raise ValueError(f"slot: want a contiguous int32 tensor of shape "
                         f"({n},) on {x.device}, got {tuple(slot.shape)} "
                         f"{slot.dtype} on {slot.device}")
    if x.device.type == "cpu":
        from repro_torch.kernels import ref  # ref imports this module

        return ref.compress(x, slot, c, s)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    rc = _build.load().tamuna_compress(
        x.data_ptr(), _DTYPES[x.dtype], slot.data_ptr(), out.data_ptr(), n,
        x.shape[-1], c, s, _build.stream_of(x))
    rank = "" if x.dim() == 2 else "_1d"
    _build.check_launch(
        f"compress{rank}_{'f64' if x.dtype == torch.float64 else 'f32'}", rc)
    return out
