"""The wire quantizer as one CUDA pass per kind group.

No Pallas kernel does this: the reference quantizes with jnp
(``repro.dist.wire.leaf_scales`` + ``quantize_to_int`` inside
``comm_ws._wire_pack``, and ``wire.quantize`` inside ``comm_ws._down_quant``
for the DownCom).  On the card the counter hash is uint32 arithmetic that
torch can only emulate in int64, some 25 passes over every (row,
coordinate) pair; the kernel does it in registers.

``pack_int`` gives the UpCom payload of a kind group of the ``(n,
d_total)`` f32 workspace: int8 codes ``(n, d_g)`` and f32 scales ``(n,
nc_g)``, the group's leaves concatenated in the given order; ``row0`` is
the global id of the workspace's first row (a rank's first client under
data parallelism), so a rank's codes are those of its rows in the whole
population's pack.  It reads
4 B and writes 1 B per (row, coordinate), bound by bytes.  ``quantize_down``
quantizes the DownCom ``x_bar`` in place, one shared row with row id
``wire.DOWN_ROW``.  A kind group's leaves are ``(leaf index, offset in the
row, size)`` triples; the leaf index (the leaf's place in the full leaf
list) keys the draw.  The kernel runs one warp per 256-coordinate chunk
(``csrc/tamuna_kernels.cu``, ``wire_quantize_kernel``); its leaf tables
are built on the host and copied to the card once, so neither wrapper
waits for the card.

Both take a coordinate-table form for the blocks of model-sharded leaves
(``coords=``, ``scales=``, ``gdims=``): each group column's global leaf
coordinate keys its draw and picks its scale among the given ones
(``wire.leaf_scales_at``, already reduced over the leaf's blocks), leaf
``j``'s scales in the ``n_chunks(gdims[j])`` columns after the previous
leaves'.  The kernel (``wire_quantize_at_kernel``) then computes no scale;
the UpCom returns the scales poisoned (NaN) where its rows' chunk holds a
nonfinite value, as ``wire.quantize_to_int``.  It reads 4 B of x and 8 B
of coordinate and writes 1 B of code per (row, coordinate).  Without the
table every launch is the one above.

A CPU tensor runs the plain versions ``ref.wire_pack``/``ref.wire_down``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.dist import wire
from repro_torch.kernels import _build, compress, ref

Leaves = Sequence[Tuple[int, int, int]]


def _tables(leaves: Leaves, dst_of_src: bool
            ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The kernel's leaf table, ``(L, 4)`` flattened: ``(source offset,
    size, destination offset, leaf index)``, and the group's chunk offsets
    ``(L + 1,)``, as host tuples.  The destination is the group column
    (``pack_int``) or the source itself (``quantize_down``, in place).  The
    kernel folds the round's seed with each leaf index itself, so the
    tables do not change from round to round and their device copies are
    made once (``_build.device_table``)."""
    tab, lo = [], [0]
    for li, o, D in leaves:
        tab += [o, D, o if dst_of_src else lo[-1], li]
        lo.append(lo[-1] + D)
    return tuple(tab), tuple(compress.chunk_offsets(lo))


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


def _at_tables(x: torch.Tensor, leaves: Leaves, coords: torch.Tensor,
               scales: torch.Tensor, gdims: Sequence[int], rows: int
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Check the coordinate-table form's inputs; returns the host tables
    ``(lo, scol)``: the group column starts (``L + 1``) and each leaf's
    first scale column (``L``)."""
    lo, scol = [0], [0]
    for (_, _, D), G in zip(leaves, gdims):
        lo.append(lo[-1] + D)
        scol.append(scol[-1] + wire.n_chunks(G))
    if (len(gdims) != len(leaves) or coords.dtype != torch.int64
            or coords.shape != (lo[-1],) or not coords.is_contiguous()
            or coords.device != x.device or scales.dtype != torch.float32
            or scales.shape != (rows, scol[-1])
            or not scales.is_contiguous() or scales.device != x.device
            or any(D > G for (_, _, D), G in zip(leaves, gdims))):
        raise ValueError(
            f"coordinate form: want coords ({lo[-1]},) int64 and scales "
            f"({rows}, {scol[-1]}) f32 on {x.device}, one global size per "
            f"leaf at least its block's; got coords {tuple(coords.shape)} "
            f"{coords.dtype}, scales {tuple(scales.shape)} {scales.dtype}, "
            f"gdims {list(gdims)}")
    return tuple(lo), tuple(scol[:-1])


def pack_int(x: torch.Tensor, leaves: Leaves, kind: str, seed: int,
             row0: int = 0, *, coords: Optional[torch.Tensor] = None,
             scales: Optional[torch.Tensor] = None,
             gdims: Optional[Sequence[int]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes (n, d_g) int8, scales (n, nc_g) f32)`` of the leaves of the
    ``(n, d_total)`` f32 workspace ``x``: ``wire.leaf_scales`` then
    ``wire.quantize_to_int`` per leaf, row ``i`` drawing with row id
    ``row0 + i`` and leaf ``li`` with ``wire.fold_seed(seed, li)``.

    The coordinate form (``coords`` ``(d_g,)`` int64, the global leaf
    coordinate of each group column; ``scales`` ``(n, nc_g)`` f32 over the
    leaves' global chunks; ``gdims`` the leaves' global sizes): the codes
    draw at the global coordinates against the given scales, and the
    scales come back poisoned where a row's chunk holds a nonfinite
    value."""
    _check(x, leaves, kind)
    if x.dim() != 2:
        raise ValueError(f"want an (n, d) workspace, got {tuple(x.shape)}")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if coords is not None:
        lo, scol = _at_tables(x, leaves, coords, scales, gdims, x.shape[0])
        if x.device.type == "cpu":
            return ref.wire_pack(x, leaves, kind, seed, row0, coords=coords,
                                 scales=scales, gdims=gdims)
        n = x.shape[0]
        codes = torch.empty(n, lo[-1], dtype=torch.int8, device=x.device)
        out = scales.clone()
        tab, _ = _tables(leaves, dst_of_src=False)
        rc = _build.load().tamuna_wire_quantize(
            x.data_ptr(), x.shape[1], n,
            _build.device_table(tab, x.device).data_ptr(),
            _build.device_table(scol, x.device).data_ptr(), len(leaves),
            scales.shape[1], int(seed) & 0xFFFFFFFF,
            float(wire.LEVELS[kind]), codes.data_ptr(), lo[-1],
            out.data_ptr(), scales.shape[1], None, 0, int(row0),
            coords.data_ptr(), _build.device_table(lo, x.device).data_ptr(),
            lo[-1], scales.data_ptr(), _build.stream_of(x))
        _build.check_launch("wire_quantize_at", rc)
        return codes, out
    if x.device.type == "cpu":
        return ref.wire_pack(x, leaves, kind, seed, row0)
    n = x.shape[0]
    d_g = sum(D for _, _, D in leaves)
    tab, coff = _tables(leaves, dst_of_src=False)
    nc = coff[-1]
    codes = torch.empty(n, d_g, dtype=torch.int8, device=x.device)
    scales = torch.empty(n, nc, dtype=torch.float32, device=x.device)
    rc = _build.load().tamuna_wire_quantize(
        x.data_ptr(), x.shape[1], n,
        _build.device_table(tab, x.device).data_ptr(),
        _build.device_table(coff, x.device).data_ptr(), len(leaves), nc,
        int(seed) & 0xFFFFFFFF, float(wire.LEVELS[kind]), codes.data_ptr(),
        d_g, scales.data_ptr(), nc, None, 0, int(row0), None, None, 0, None,
        _build.stream_of(x))
    _build.check_launch("wire_quantize", rc)
    return codes, scales


def quantize_down(x_bar: torch.Tensor, leaves: Leaves, kind: str,
                  seed: int, *, coords: Optional[torch.Tensor] = None,
                  scales: Optional[torch.Tensor] = None,
                  gdims: Optional[Sequence[int]] = None) -> None:
    """In place on the ``(d_total,)`` f32 ``x_bar``: each leaf becomes
    ``wire.quantize`` of it as one row with row id ``wire.DOWN_ROW``
    (nonfinite values pass through).  ``coords``, ``scales`` ``(1,
    nc_g)`` and ``gdims``: ``pack_int``'s coordinate form."""
    _check(x_bar, leaves, kind)
    if x_bar.dim() != 1:
        raise ValueError(f"want a (d,) row, got {tuple(x_bar.shape)}")
    if coords is not None:
        lo, scol = _at_tables(x_bar, leaves, coords, scales, gdims, 1)
        if x_bar.device.type == "cpu":
            ref.wire_down(x_bar, leaves, kind, seed, coords=coords,
                          scales=scales, gdims=gdims)
            return
        tab, _ = _tables(leaves, dst_of_src=True)
        rc = _build.load().tamuna_wire_quantize(
            x_bar.data_ptr(), 0, 1,
            _build.device_table(tab, x_bar.device).data_ptr(),
            _build.device_table(scol, x_bar.device).data_ptr(), len(leaves),
            scales.shape[1], int(seed) & 0xFFFFFFFF,
            float(wire.LEVELS[kind]), None, 0, None, scales.shape[1],
            x_bar.data_ptr(), 1, 0, coords.data_ptr(),
            _build.device_table(lo, x_bar.device).data_ptr(), lo[-1],
            scales.data_ptr(), _build.stream_of(x_bar))
        _build.check_launch("wire_quantize_at", rc)
        return
    if x_bar.device.type == "cpu":
        ref.wire_down(x_bar, leaves, kind, seed)
        return
    tab, coff = _tables(leaves, dst_of_src=True)
    rc = _build.load().tamuna_wire_quantize(
        x_bar.data_ptr(), 0, 1,
        _build.device_table(tab, x_bar.device).data_ptr(),
        _build.device_table(coff, x_bar.device).data_ptr(), len(leaves),
        coff[-1], int(seed) & 0xFFFFFFFF, float(wire.LEVELS[kind]), None, 0,
        None, 0, x_bar.data_ptr(), 1, 0, None, None, 0, None,
        _build.stream_of(x_bar))
    _build.check_launch("wire_quantize", rc)
