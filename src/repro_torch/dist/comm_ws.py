"""The client workspace and the unmeshed comm step (``repro.dist.comm_ws``).

The state of every client lives in one ``(n, d_total)`` f32 workspace per
quantity (x and h), each row one client's parameters flattened leaf by
leaf in the reference's leaf order (``WorkspaceSpec``).  Where the
reference packs its per-leaf state into that layout and unpacks it again
each round (``comm_ws.pack``/``unpack``, two copies of the state), the port
keeps the state in it: a leaf is a view into a row, the local step updates
a client's row in place and the comm step updates both workspaces in
place.  The numbers are those of the reference's kernel path
(``comm_ws._pallas_comm``: the mean, survivor and robust rebuilds, over
the f32 workspace or the quantized wire); only the copies are gone.

The quantized wire (DESIGN.md §13) narrows only the UpCom's payload.  The
reference packs one workspace per wire kind; here x and h stay in the one
f32 workspace and only the payload buffers are per kind group (int8 codes
with their scales, or f16/bf16 lanes), each over its leaves' columns in
leaf order with the band restarting at every leaf.  ``x_bar`` is assembled
over the whole row, optionally goes through the DownCom quantizer, and one
``h_update`` then reads the raw f32 workspace: the h update and the
DownCom never read wire values.

The cyclic band ``(-s k_leaf) mod c`` restarts at every leaf, so the leaf
order and the stacked ``(n_layers, ...)`` block leaves decide which client
owns which coordinate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.dist import wire as wire_mod
from repro_torch.kernels import compress, ref, uplink, wire_pack


@dataclasses.dataclass(frozen=True)
class WorkspaceSpec:
    """Leaf-offset table of one workspace row."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]  # per-client leaf shapes
    dims: Tuple[int, ...]  # flattened leaf sizes D
    offsets: Tuple[int, ...]  # leaf start offsets in the row
    d_total: int


def workspace_spec(specs: Sequence[Tuple[str, Tuple[int, ...]]]
                   ) -> WorkspaceSpec:
    """The offset table of ``[(name, shape)]`` leaves, in that order."""
    names = tuple(name for name, _ in specs)
    shapes = tuple(tuple(shape) for _, shape in specs)
    dims = tuple(int(torch.Size(shape).numel()) for shape in shapes)
    offsets, o = [], 0
    for D in dims:
        offsets.append(o)
        o += D
    return WorkspaceSpec(names, shapes, dims, tuple(offsets), o)


def leaf_views(row: torch.Tensor, spec: WorkspaceSpec
               ) -> Dict[str, torch.Tensor]:
    """Views of one ``(d_total,)`` row as the named leaves (no copy)."""
    return {
        name: row[o:o + D].view(shape)
        for name, shape, D, o in zip(spec.names, spec.shapes, spec.dims,
                                     spec.offsets)
    }


def unpack(ws: torch.Tensor, spec: WorkspaceSpec) -> Dict[str, torch.Tensor]:
    """Views of an ``(n, d_total)`` workspace as client-stacked
    ``(n, *shape)`` leaves (no copy)."""
    n = ws.shape[0]
    return {
        name: ws[:, o:o + D].view((n,) + shape)
        for name, shape, D, o in zip(spec.names, spec.shapes, spec.dims,
                                     spec.offsets)
    }


def pack(leaves: Dict[str, torch.Tensor], spec: WorkspaceSpec,
         out: torch.Tensor) -> torch.Tensor:
    """Copy named leaves (each of shape ``out.shape[:-1] + leaf shape``)
    into the workspace ``out`` in place."""
    lead = tuple(out.shape[:-1])
    for name, shape, D, o in zip(spec.names, spec.shapes, spec.dims,
                                 spec.offsets):
        out[..., o:o + D].view(lead + shape).copy_(leaves[name])
    return out


def cyclic_band(dims: Sequence[int], c: int, s: int,
                device) -> torch.Tensor:
    """``(d_total,)`` int32 band of the packed workspace: each leaf's
    coordinates ``k`` get ``(-s k) mod c``, restarting at every leaf
    (``comm_ws._cyclic_band_np``), built on ``device``.  The band of a
    leaf repeats with period ``c``, so one period is tiled."""
    period = compress.cyclic_band(
        torch.arange(c, dtype=torch.int32, device=device), c, s)
    out = torch.empty(sum(dims), dtype=torch.int32, device=device)
    o = 0
    for D in dims:
        out[o:o + D] = period.repeat(-(-D // c))[:D]
        o += D
    return out


@dataclasses.dataclass(frozen=True)
class WireGroup:
    """The leaves of one wire kind: ``leaves`` are ``(leaf index, offset
    in the row, size)`` in leaf order, ``leaf_lo`` the ``L + 1`` host
    integers of their starts in the group's columns (the last ``d_g``),
    ``band`` ``(d_g,)`` int32 the cyclic band over those columns;
    ``whole``: the group is the whole row.  The host tables keep the comm
    step from reading anything back from the card."""

    kind: str
    leaves: Tuple[Tuple[int, int, int], ...]
    leaf_lo: Tuple[int, ...]
    band: torch.Tensor
    whole: bool


def wire_plan(dims: Sequence[int], policy: Optional[str], c: int, s: int,
              band: torch.Tensor) -> Optional[Tuple[WireGroup, ...]]:
    """The kind groups of a row of leaves ``dims`` under the wire
    ``policy``, in kind order; ``None`` for the f32 wire (``None`` or
    ``"f32"``).
    ``band`` is the row's cyclic band; a group that is the whole row
    reuses it, any other gets its own (the same values at its columns)."""
    if not wire_mod.is_wire(policy):
        return None
    kinds = tuple(wire_mod.resolve_kind(D, policy) for D in dims)
    offsets = [sum(dims[:i]) for i in range(len(dims))]
    groups = []
    for kind in sorted(set(kinds)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        gdims = [dims[i] for i in idx]
        lo = [0]
        for D in gdims:
            lo.append(lo[-1] + D)
        whole = len(idx) == len(dims)
        groups.append(WireGroup(
            kind=kind,
            leaves=tuple((i, offsets[i], dims[i]) for i in idx),
            leaf_lo=tuple(lo),
            band=band if whole else cyclic_band(gdims, c, s, band.device),
            whole=whole))
    return tuple(groups)


def _group_cols(leaves) -> Iterator[Tuple[int, int, int]]:
    """``(group column, row offset, width)`` of the column chunks of a
    group's leaves."""
    g0 = 0
    for _, o, D in leaves:
        for cols in ref.column_chunks(D):
            yield g0 + cols.start, o + cols.start, cols.stop - cols.start
        g0 += D


def _wire_upcom(xw: torch.Tensor, slot: torch.Tensor, c: int, s: int,
                grp: WireGroup, seed: int, survivor: bool,
                robust: Optional[Tuple[str, int]]):
    """One kind group's UpCom from its wire payload: ``(x_bar_g,
    covered_g)`` over the group's columns, ``covered_g`` ``None`` unless
    ``survivor``.  Robust combines run on dequantized f32 values, in
    column chunks (the combine is per coordinate)."""
    n = xw.shape[0]
    d_g = grp.leaf_lo[-1]
    if grp.kind in wire_mod.F_DTYPES:
        lanes = torch.empty(n, d_g, dtype=wire_mod.F_DTYPES[grp.kind],
                            device=xw.device)
        for g, o, w in _group_cols(grp.leaves):
            lanes[:, g:g + w] = wire_mod.narrow(xw[:, o:o + w], grp.kind)

        def f32_cols(a, b):
            return lanes[:, a:b].to(torch.float32).contiguous()

        def upcom(counts):
            return uplink.masked_sum(lanes, slot, grp.band, c, s,
                                     counts=counts)
    else:
        codes, scales = wire_pack.pack_int(xw, grp.leaves, grp.kind, seed)

        def f32_cols(a, b):
            lo = torch.tensor(grp.leaf_lo, dtype=torch.int64,
                              device=xw.device)
            return compress.wire_dequant(
                codes[:, a:b], scales,
                compress.chunk_cols(lo, a, b)).contiguous()

        def upcom(counts):
            return uplink.masked_sum_dequant(codes, scales, grp.leaf_lo,
                                             slot, grp.band, c, s,
                                             counts=counts)
    covered = None
    if robust is not None:
        x_bar = torch.empty(d_g, dtype=torch.float32, device=xw.device)
        cnt = torch.empty(d_g, dtype=torch.float32, device=xw.device)
        for cols in ref.column_chunks(d_g):
            x_bar[cols], cnt[cols] = uplink.robust_sum(
                f32_cols(cols.start, cols.stop), slot, grp.band[cols], c, s,
                kind=robust[0], k=robust[1])
        if survivor:
            covered = cnt > 0
    elif survivor:
        x_bar, cnt = upcom(True)
        covered = cnt > 0
        x_bar.div_(cnt.clamp_(min=1.0))
    else:
        x_bar = upcom(False)
    return x_bar, covered


def _wire_downcom(x_bar: torch.Tensor, groups: Tuple[WireGroup, ...],
                  seed: int) -> None:
    """The DownCom quantizer in place on ``x_bar``: each leaf at its kind,
    one shared row keyed ``wire.DOWN_ROW`` (``comm_ws._make_xbar_tx``)."""
    for grp in groups:
        if grp.kind in wire_mod.LEVELS:
            wire_pack.quantize_down(x_bar, grp.leaves, grp.kind, seed)
            continue
        for _, o, w in _group_cols(grp.leaves):
            seg = x_bar[o:o + w]
            seg.copy_(wire_mod.quantize(seg[None], grp.kind)[0])


def cyclic_comm(xw: torch.Tensor, hw: torch.Tensor, slot: torch.Tensor,
                band: torch.Tensor, c: int, s: int, scale: float,
                down: Optional[torch.Tensor] = None,
                arrived: Optional[torch.Tensor] = None,
                correct: bool = True,
                robust: Optional[Tuple[str, int]] = None,
                wire: Optional[Tuple[WireGroup, ...]] = None,
                wire_seed: int = 0,
                wire_down: bool = False) -> torch.Tensor:
    """UpCom + control-variate update + DownCom of the cyclic template, in
    place on the workspaces; returns the rebuilt server model ``x_bar``.

    ``slot`` ``(n,)`` int32 is each client's template column (-1 when idle),
    ``down`` ``(n,)`` int32 the DownCom rows (``None``: every row).

    ``arrived`` ``(n,)`` bool (the fault-tolerant round) demotes the rows
    that did not arrive to ``slot = -1``; with ``correct`` the rebuild is
    the survivor mean ``num / max(cnt, 1)`` over the arrived owners, and
    coordinates no arrived row owns keep h and x untouched.  ``robust``
    (``robust.normalize_robust``'s spec) replaces the mean by a trimmed
    mean or median; it is gated the same way on survivor rounds.

    ``wire`` (``wire_plan``) sends the UpCom over the quantized wire with
    the round's uint32 ``wire_seed``: each kind group's payload is packed
    from the raw rows (idle rows included: ownership selects) and the
    survivor rebuild and the robust combine run after dequantization.
    ``wire_down`` also quantizes ``x_bar`` before the DownCom.  ``wire=None``
    is the f32 path.  The reference's kernel path, ``comm_ws._pallas_comm``."""
    survivor = arrived is not None and correct
    if arrived is not None:
        slot = torch.where(arrived.to(slot.device), slot, -1).to(torch.int32)
    covered = None
    if wire is not None:
        seed = int(wire_seed) & 0xFFFFFFFF
        parts = [(grp, *_wire_upcom(xw, slot, c, s, grp, seed, survivor,
                                    robust)) for grp in wire]
        if len(parts) == 1 and parts[0][0].whole:
            _, x_bar, covered = parts[0]
        else:
            x_bar = torch.empty(xw.shape[1], dtype=torch.float32,
                                device=xw.device)
            if survivor:
                covered = torch.empty(xw.shape[1], dtype=torch.bool,
                                      device=xw.device)
            for grp, bar_g, cov_g in parts:
                g0 = 0
                for _, o, D in grp.leaves:
                    x_bar[o:o + D] = bar_g[g0:g0 + D]
                    if survivor:
                        covered[o:o + D] = cov_g[g0:g0 + D]
                    g0 += D
        del parts
        if wire_down:
            _wire_downcom(x_bar, wire, seed)
    elif robust is not None:
        x_bar, cnt = uplink.robust_sum(xw, slot, band, c, s, kind=robust[0],
                                       k=robust[1])
        if survivor:
            covered = cnt > 0
        del cnt
    elif survivor:
        # comm_ws._survivor_bar, in place on the sum
        x_bar, cnt = uplink.masked_sum(xw, slot, band, c, s, counts=True)
        covered = cnt > 0
        x_bar.div_(cnt.clamp_(min=1.0))
        del cnt
    else:
        x_bar = uplink.masked_sum(xw, slot, band, c, s)
    uplink.h_update(xw, hw, x_bar, slot, band, c, s, scale, down=down,
                    covered=covered)
    return x_bar
