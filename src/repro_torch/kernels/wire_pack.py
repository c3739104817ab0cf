"""The wire quantizer as one CUDA pass per kind group.

No Pallas kernel does this: the reference quantizes with jnp
(``repro.dist.wire.leaf_scales`` + ``quantize_to_int`` inside
``comm_ws._wire_pack``, and ``wire.quantize`` inside ``comm_ws._down_quant``
for the DownCom).  On the card the counter hash is uint32 arithmetic that
torch can only emulate in int64, some 25 passes over every (row,
coordinate) pair; the kernel does it in registers.

``pack_int`` gives the UpCom payload of a kind group of the ``(n,
d_total)`` f32 workspace: int8 codes ``(n, d_g)`` and f32 scales ``(n,
nc_g)``, the group's leaves concatenated in the given order.  It reads
4 B and writes 1 B per (row, coordinate), bound by bytes.  ``quantize_down``
quantizes the DownCom ``x_bar`` in place, one shared row with row id
``wire.DOWN_ROW``.  A kind group's leaves are ``(leaf index, offset in the
row, size)`` triples; the leaf index (the leaf's place in the full leaf
list) keys the draw.

A CPU tensor runs the plain versions ``ref.wire_pack``/``ref.wire_down``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.dist import wire
from repro_torch.kernels import _build, compress, ref

Leaves = Sequence[Tuple[int, int, int]]


def _tables(leaves: Leaves, seed: int, device, dst_of_src: bool):
    """The kernel's leaf table ``(L, 4)`` int64 ``(source offset, size,
    destination offset, folded seed)`` and chunk offsets ``(L + 1,)``; the
    destination is the group column (``pack_int``) or the source itself
    (``quantize_down``, in place)."""
    tab, lo = [], [0]
    for li, o, D in leaves:
        tab.append([o, D, o if dst_of_src else lo[-1],
                    wire.fold_seed(seed, li)])
        lo.append(lo[-1] + D)
    coff = compress.chunk_offsets(lo)
    return (torch.tensor(tab, dtype=torch.int64, device=device),
            torch.tensor(coff, dtype=torch.int64, device=device), coff[-1])


def _check(x: torch.Tensor, leaves: Leaves, kind: str) -> None:
    if kind not in wire.LEVELS:
        raise ValueError(f"the quantizer takes int kinds {tuple(wire.LEVELS)}"
                         f", got {kind!r}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"want a contiguous f32 tensor, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    width = x.shape[-1]
    if not leaves or any(o < 0 or D <= 0 or o + D > width
                         for _, o, D in leaves):
        raise ValueError(f"leaves {list(leaves)} do not lie in a row of "
                         f"{width}")


def pack_int(x: torch.Tensor, leaves: Leaves, kind: str,
             seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes (n, d_g) int8, scales (n, nc_g) f32)`` of the leaves of the
    ``(n, d_total)`` f32 workspace ``x``: ``wire.leaf_scales`` then
    ``wire.quantize_to_int`` per leaf, row ``i`` drawing with row id
    ``i`` and leaf ``li`` with ``wire.fold_seed(seed, li)``."""
    _check(x, leaves, kind)
    if x.dim() != 2:
        raise ValueError(f"want an (n, d) workspace, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.wire_pack(x, leaves, kind, seed)
    n = x.shape[0]
    d_g = sum(D for _, _, D in leaves)
    tab, coff, nc = _tables(leaves, seed, x.device, dst_of_src=False)
    codes = torch.empty(n, d_g, dtype=torch.int8, device=x.device)
    scales = torch.empty(n, nc, dtype=torch.float32, device=x.device)
    rc = _build.load().tamuna_wire_quantize(
        x.data_ptr(), x.shape[1], n, tab.data_ptr(), coff.data_ptr(),
        len(leaves), nc, float(wire.LEVELS[kind]), codes.data_ptr(), d_g,
        scales.data_ptr(), nc, None, 0, _build.stream_of(x))
    _build.check_launch("wire_quantize", rc)
    return codes, scales


def quantize_down(x_bar: torch.Tensor, leaves: Leaves, kind: str,
                  seed: int) -> None:
    """In place on the ``(d_total,)`` f32 ``x_bar``: each leaf becomes
    ``wire.quantize`` of it as one row with row id ``wire.DOWN_ROW``
    (nonfinite values pass through)."""
    _check(x_bar, leaves, kind)
    if x_bar.dim() != 1:
        raise ValueError(f"want a (d,) row, got {tuple(x_bar.shape)}")
    if x_bar.device.type == "cpu":
        ref.wire_down(x_bar, leaves, kind, seed)
        return
    tab, coff, nc = _tables(leaves, seed, x_bar.device, dst_of_src=True)
    rc = _build.load().tamuna_wire_quantize(
        x_bar.data_ptr(), 0, 1, tab.data_ptr(), coff.data_ptr(), len(leaves),
        nc, float(wire.LEVELS[kind]), None, 0, None, 0, x_bar.data_ptr(), 1,
        _build.stream_of(x_bar))
    _build.check_launch("wire_quantize", rc)
