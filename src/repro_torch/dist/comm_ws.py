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
owns which coordinate.  The blocked template (``uplink="block_rs"``) has
the block band ``k_leaf // ceil(D / c)`` (``block_band``): each leaf
chunks into ``c`` contiguous blocks, the last one ragged, and the round's
shift ``off`` moves cohort slot ``j`` to the kernel slot ``(-(j + off))
mod c`` (``blocked_slot``), so the same kernels with the same predicate
``(slot + band) mod c < s`` run both templates (``blocked_comm``).

A leaf with ``D s < c`` is tall and thin: the cyclic template then owns
coordinate ``k`` by the columns ``k + t D`` (paper Fig. 1, right), which no
band expresses.  ``workspace_spec(..., last=)`` lays such leaves after all
the others, the kernels run over the columns before them (a row pitch of
``d_total``), and ``cyclic_comm(tall=)`` takes each of them through the
dense per-leaf closed form, as the reference's kernel branch does.

``shard_comm`` is the same step on one rank's rows under data
parallelism (the reference's shard-resident ``_shard_comm`` on the data
axis, ``sharding.RankRows``): the kernels run on the rank's rows, the
ranks' d-sized partials are summed (``torch.distributed.all_reduce``),
and the robust combines exchange ``(s, chunk)`` owner-value stacks.

Under model parallelism (``sharding.Mesh2D``) a rank's workspace row
holds its blocks of the leaves, in the same leaf order.  A block that is
not the whole leaf carries the global flat coordinate of each of its
columns (``sharding.shard_coords``): its band comes from those
(``cyclic_band_at``, ``block_band_at``; ``band_of_blocks`` assembles a
row's), so every coordinate keeps the owners it has in the unsharded
leaf, and its int wire draws at them with the scales of the whole leaf's
chunks (``wire.leaf_scales_at``: a scatter-max over the block, then one
``MAX`` over the model group per kind group), so the codes are the
unsharded ones.  The kernels run on the block as on any row; only the
quantizer and the dequantizing UpCom take the blocks' coordinate and
scale-column tables (``wire_plan(coords=)``).  No sum runs over the model
group: each coordinate's owners are the rows of one block column.

``cyclic_comm_leaves`` and ``blocked_comm_leaves`` are the reference's
two plain implementations of each template, ``impl="ws"`` (the sparse
UpCom: ``s`` owner-row gathers per leaf, or ``s`` contiguous chunk gathers
per block, then one fused h update and DownCom) and ``impl="dense"`` (the
materialized ``(n, D)`` ownership mask, the reference's ground truth),
over client-stacked leaves in any float storage type, with the mean, survivor
and robust rebuilds (``robust.robust_combine_stack`` over the ``(s, D)``
owner stack or the masked ``(n, D)`` stack).  Like the reference they
compute the comm step in f32 whatever the storage type and return new
leaves in it: x and h leave the step as (for f64 storage) f64 tensors
holding f32 values.  They are plain PyTorch by design: the reference keeps
them as jnp, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import (Collection, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core import masks
from repro_torch.dist import robust as robust_mod
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
    ids: Tuple[int, ...] = ()  # each leaf's index in the reference's order
    n_main: int = -1  # the leaves before the ones laid last (-1: all)

    @property
    def d_main(self) -> int:
        """The columns of the leaves before those laid last."""
        k = self.main_leaves
        return self.offsets[k] if k < len(self.dims) else self.d_total

    @property
    def main_leaves(self) -> int:
        return len(self.dims) if self.n_main < 0 else self.n_main


def workspace_spec(specs: Sequence[Tuple[str, Tuple[int, ...]]],
                   last: Collection[str] = ()) -> WorkspaceSpec:
    """The offset table of ``[(name, shape)]`` leaves, in that order, but
    for the leaves named in ``last``, which go after all the others (in
    their order).  ``ids`` keeps each leaf's index in ``specs``, the
    reference's leaf index that keys the wire's draws."""
    order = ([i for i, (nm, _) in enumerate(specs) if nm not in last]
             + [i for i, (nm, _) in enumerate(specs) if nm in last])
    names = tuple(specs[i][0] for i in order)
    shapes = tuple(tuple(specs[i][1]) for i in order)
    dims = tuple(int(torch.Size(shape).numel()) for shape in shapes)
    offsets, o = [], 0
    for D in dims:
        offsets.append(o)
        o += D
    n_main = len(specs) - sum(1 for nm, _ in specs if nm in last)
    return WorkspaceSpec(names, shapes, dims, tuple(offsets), o,
                         tuple(order), n_main)


def tall_leaves(dims: Sequence[int], c: int, s: int) -> List[int]:
    """The positions of the tall-and-thin leaves (``D s < c``) of
    ``dims``."""
    return [i for i, D in enumerate(dims) if D * s < c]


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


def block_band(dims: Sequence[int], c: int, device) -> torch.Tensor:
    """``(d_total,)`` int32 band of the blocked template: each leaf's
    coordinates ``k`` get their block ``k // ceil(D / c)`` (the last block
    ragged), restarting at every leaf (``comm_ws._block_band_np``); every
    value lies in ``[0, c)``.  Built on ``device`` in chunks."""
    out = torch.empty(sum(dims), dtype=torch.int32, device=device)
    o = 0
    for D in dims:
        chunk = -(-D // c)
        for cols in ref.column_chunks(D):
            out[o + cols.start:o + cols.stop] = torch.div(
                torch.arange(cols.start, cols.stop, dtype=torch.int64,
                             device=device), chunk,
                rounding_mode="floor").to(torch.int32)
        o += D
    return out


def cyclic_band_at(coords: torch.Tensor, c: int, s: int) -> torch.Tensor:
    """The cyclic band ``(-s k) mod c`` of a block's global leaf
    coordinates ``coords`` (int64; ``comm_ws._leaf_band`` with ``k_arr``),
    int32 on their device."""
    return compress.cyclic_band(coords, c, s).to(torch.int32)


def block_band_at(coords: torch.Tensor, D: int, m: int) -> torch.Tensor:
    """The blocked template's band ``k // ceil(D / m)`` of a block's global
    coordinates ``coords`` of a leaf of ``D``, int32 on their device."""
    return torch.div(coords, -(-D // m),
                     rounding_mode="floor").to(torch.int32)


def band_of_blocks(dims: Sequence[int], gdims: Sequence[int],
                   coords: Sequence[Optional[torch.Tensor]], template: str,
                   c: int, s: int, device) -> torch.Tensor:
    """``(sum(dims),)`` int32 band of a row of leaf blocks: a whole leaf
    (``coords[i]`` ``None``) takes ``cyclic_band``'s or ``block_band``'s
    table, a block of a leaf of ``gdims[i]`` the band of its coordinates
    (int64, moved to ``device``), computed there once."""
    out = torch.empty(sum(dims), dtype=torch.int32, device=device)
    o = 0
    for D, G, k in zip(dims, gdims, coords):
        if k is None:
            out[o:o + D] = (cyclic_band([D], c, s, device)
                            if template == "cyclic"
                            else block_band([D], c, device))
        else:
            k = k.to(device)
            out[o:o + D] = (cyclic_band_at(k, c, s) if template == "cyclic"
                            else block_band_at(k, G, c))
        o += D
    return out


def whole_chunks(k: torch.Tensor) -> bool:
    """Whether a block's coordinates ``k`` are whole wire chunks in order,
    each a run of 256 columns (``wire.chunk_max_at``'s fast form); reads
    two flags back where ``k`` lies on the card (once, at plan time)."""
    C = wire_mod.CHUNK
    return (k.numel() % C == 0 and bool((k[::C] % C == 0).all())
            and bool((k[C - 1::C] - k[::C] == C - 1).all()))


def blocked_slot(slot_of: torch.Tensor, off: int, c: int) -> torch.Tensor:
    """The kernel slots of the blocked template: cohort slot ``j`` (``(n,)``
    int, -1 idle) owns the blocks ``(j + off) .. (j + off + s - 1) mod c``,
    which is the kernels' ``(slot + band) mod c < s`` at ``slot = (-(j +
    off)) mod c`` with a floor modulo; idle rows stay -1.  int32."""
    sl = slot_of.to(torch.int64)
    return torch.where(sl >= 0, torch.remainder(-(sl + int(off)), c),
                       -1).to(torch.int32)


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
    # the coordinate-table form (an int group holding a block of a
    # model-sharded leaf; None otherwise): the leaves' global sizes, each
    # group column's global leaf coordinate (int64) and scale column
    # (int32) over the leaves' global chunks, which leaves are whole wire
    # chunks (``whole_chunks``), and the model group the scales are maxed
    # over
    gdims: Optional[Tuple[int, ...]] = None
    coords: Optional[torch.Tensor] = None
    chunk_col: Optional[torch.Tensor] = None
    runs: Optional[Tuple[bool, ...]] = None
    model: object = None

    @property
    def scale_lo(self) -> Tuple[int, ...]:
        """The coordinate form's ``L + 1`` starts of each leaf's global
        chunks in the group's scales."""
        lo = [0]
        for G in self.gdims:
            lo.append(lo[-1] + wire_mod.n_chunks(G))
        return tuple(lo)


def wire_plan(dims: Sequence[int], policy: Optional[str], c: int, s: int,
              band: torch.Tensor, *, template: str = "cyclic",
              ids: Optional[Sequence[int]] = None,
              gdims: Optional[Sequence[int]] = None,
              coords: Optional[Sequence[Optional[torch.Tensor]]] = None,
              model=None) -> Optional[Tuple[WireGroup, ...]]:
    """The kind groups of a row of leaves ``dims`` under the wire
    ``policy``, in kind order; ``None`` for the f32 wire (``None`` or
    ``"f32"``).
    ``band`` is the row's band of the ``template`` (``"cyclic"`` or
    ``"blocked"``); a group that is the whole row reuses it, any other gets
    its own (the same values at its columns).  ``ids`` are the leaves'
    reference indices (default ``0, 1, ...``), which key their draws.

    Model-sharded blocks: ``dims`` are the blocks' sizes, ``gdims`` the
    leaves' (the kinds resolve on them, as the reference's), ``coords``
    each block's global coordinates (``None`` for a whole leaf) and
    ``model`` the model group (a ``tensor_parallel.TensorParallel``).  An
    int group that holds a block gets the coordinate-table form, its
    tables built on ``band``'s device once."""
    if not wire_mod.is_wire(policy):
        return None
    if template not in ("cyclic", "blocked"):
        raise ValueError(f"unknown template {template!r}")
    ids = list(range(len(dims))) if ids is None else list(ids)
    gdims = list(dims) if gdims is None else list(gdims)
    coords = [None] * len(dims) if coords is None else list(coords)
    kinds = tuple(wire_mod.resolve_kind(G, policy) for G in gdims)
    offsets = [sum(dims[:i]) for i in range(len(dims))]
    groups = []
    for kind in sorted(set(kinds)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        lo = [0]
        for i in idx:
            lo.append(lo[-1] + dims[i])
        whole = len(idx) == len(dims)
        split = any(coords[i] is not None for i in idx)
        if whole:
            gband = band
        elif split:
            gband = torch.cat([band[offsets[i]:offsets[i] + dims[i]]
                               for i in idx])
        elif template == "cyclic":
            gband = cyclic_band([dims[i] for i in idx], c, s, band.device)
        else:
            gband = block_band([dims[i] for i in idx], c, band.device)
        at = {}
        if split and kind in wire_mod.LEVELS:
            dev = band.device
            ks = [torch.arange(dims[i], dtype=torch.int64, device=dev)
                  if coords[i] is None else coords[i].to(dev) for i in idx]
            c0, cols = 0, []
            for i, k in zip(idx, ks):
                cols.append((torch.div(k, wire_mod.CHUNK,
                                       rounding_mode="floor") + c0).to(
                    torch.int32))
                c0 += wire_mod.n_chunks(gdims[i])
            at = dict(
                gdims=tuple(gdims[i] for i in idx), coords=torch.cat(ks),
                chunk_col=torch.cat(cols),
                runs=tuple(whole_chunks(k) for k in ks), model=model)
            del ks, cols
        groups.append(WireGroup(
            kind=kind,
            leaves=tuple((ids[i], offsets[i], dims[i]) for i in idx),
            leaf_lo=tuple(lo), band=gband, whole=whole, **at))
    return tuple(groups)


def _group_scales(x2: torch.Tensor, grp: WireGroup) -> torch.Tensor:
    """The coordinate form's scales of a kind group: each leaf's chunk
    maxima of its block of the ``(rows, d_total)`` rows ``x2`` maxed into
    one ``(rows, nc_g)`` buffer, one ``MAX`` over the model group, then
    ``wire.scales_of_max``."""
    slo = grp.scale_lo
    mx = torch.zeros(x2.shape[0], slo[-1], dtype=torch.float32,
                     device=x2.device)
    for j, (_, o, D) in enumerate(grp.leaves):
        g0 = grp.leaf_lo[j]
        wire_mod.chunk_max_at(x2[:, o:o + D], grp.coords[g0:g0 + D],
                              slo[j + 1] - slo[j],
                              out=mx[:, slo[j]:slo[j + 1]],
                              whole_chunks=grp.runs[j])
    if grp.model is not None:
        grp.model.all_reduce(mx, "max")
    return wire_mod.scales_of_max(mx, grp.kind)


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
                robust: Optional[Tuple[str, int]],
                shard: Optional["_Shard"] = None):
    """One kind group's UpCom from its wire payload: ``(x_bar_g,
    covered_g)`` over the group's columns, ``covered_g`` ``None`` unless
    ``survivor``.  Robust combines run on dequantized f32 values, in
    column chunks (the combine is per coordinate).  With ``shard`` the
    workspace holds a rank's rows: the payload is packed from them with
    their global row ids, and the partials are summed over the ranks
    (``_over_ranks``) or the owner values exchanged (robust)."""
    n = xw.shape[0]
    d_g = grp.leaf_lo[-1]
    row0 = 0 if shard is None else shard.row0
    if n == 0:
        # a rank holding no rows: no payload, zero partials
        f32_cols = None

        def upcom(counts):
            z = torch.zeros(d_g, dtype=torch.float32, device=xw.device)
            return (z, torch.zeros_like(z)) if counts else z
    elif grp.kind in wire_mod.F_DTYPES:
        lanes = torch.empty(n, d_g, dtype=wire_mod.F_DTYPES[grp.kind],
                            device=xw.device)
        for g, o, w in _group_cols(grp.leaves):
            lanes[:, g:g + w] = wire_mod.narrow(xw[:, o:o + w], grp.kind)

        def f32_cols(a, b):
            return lanes[:, a:b].to(torch.float32).contiguous()

        def upcom(counts):
            return uplink.masked_sum(lanes, slot, grp.band, c, s,
                                     counts=counts)
    elif grp.coords is not None:
        # a block of a model-sharded leaf: the scales of the whole leaf's
        # chunks, then codes at the global coordinates
        codes, scales = wire_pack.pack_int(
            xw, grp.leaves, grp.kind, seed, row0, coords=grp.coords,
            scales=_group_scales(xw, grp), gdims=grp.gdims)

        def f32_cols(a, b):
            return compress.wire_dequant(
                codes[:, a:b], scales,
                grp.chunk_col[a:b].to(torch.int64)).contiguous()

        def upcom(counts):
            return uplink.masked_sum_dequant(codes, scales, grp.leaf_lo,
                                             slot, grp.band, c, s,
                                             counts=counts,
                                             chunk_col=grp.chunk_col)
    else:
        codes, scales = wire_pack.pack_int(xw, grp.leaves, grp.kind, seed,
                                           row0)

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
    if robust is not None and shard is not None:
        x_bar, covered = shard.robust_exchange(
            f32_cols, d_g, lambda t, cols: torch.remainder(
                t - grp.band[cols].to(torch.int64), c), s, robust, survivor)
    elif robust is not None:
        x_bar = torch.empty(d_g, dtype=torch.float32, device=xw.device)
        cnt = torch.empty(d_g, dtype=torch.float32, device=xw.device)
        for cols in ref.column_chunks(d_g):
            x_bar[cols], cnt[cols] = uplink.robust_sum(
                f32_cols(cols.start, cols.stop), slot, grp.band[cols], c, s,
                kind=robust[0], k=robust[1])
        if survivor:
            covered = cnt > 0
    elif survivor:
        x_bar, cnt = _over_ranks(shard, upcom(True))
        covered = cnt > 0
        x_bar.div_(cnt.clamp_(min=1.0))
    else:
        x_bar = _over_ranks(shard, upcom(False))
    return x_bar, covered


def _wire_downcom(x_bar: torch.Tensor, groups: Tuple[WireGroup, ...],
                  seed: int) -> None:
    """The DownCom quantizer in place on ``x_bar``: each leaf at its kind,
    one shared row keyed ``wire.DOWN_ROW`` (``comm_ws._make_xbar_tx``)."""
    for grp in groups:
        if grp.coords is not None:
            wire_pack.quantize_down(
                x_bar, grp.leaves, grp.kind, seed, coords=grp.coords,
                scales=_group_scales(x_bar[None], grp), gdims=grp.gdims)
            continue
        if grp.kind in wire_mod.LEVELS:
            wire_pack.quantize_down(x_bar, grp.leaves, grp.kind, seed)
            continue
        for _, o, w in _group_cols(grp.leaves):
            seg = x_bar[o:o + w]
            seg.copy_(wire_mod.quantize(seg[None], grp.kind)[0])


def _kernel_comm(xw: torch.Tensor, hw: torch.Tensor, slot: torch.Tensor,
                 band: torch.Tensor, m: int, s: int, scale: float,
                 down: Optional[torch.Tensor], survivor: bool,
                 robust: Optional[Tuple[str, int]],
                 wire: Optional[Tuple[WireGroup, ...]], seed: int,
                 wire_down: bool,
                 shard: Optional["_Shard"] = None) -> torch.Tensor:
    """The kernel path over the first ``d = band.numel()`` columns of the
    workspaces (``comm_ws._pallas_comm``), in place; ``slot`` is already
    demoted where rows did not arrive.  Returns ``x_bar`` ``(d,)``.

    ``shard`` (``shard_comm``): the workspaces, ``slot`` and ``down`` are
    a rank's rows, and the rebuild combines the ranks' partials as the
    reference's ``_shard_comm`` does: the ``1/s``-folded ``masked_sum``
    summed over the ranks (one sum per wire kind group), or the survivor's
    numerator and count summed and divided after, or the robust
    combine's owner values exchanged; the h update and DownCom then run
    on the rank's rows."""
    d = band.numel()
    xm, hm = xw[:, :d], hw[:, :d]
    covered = None
    if wire is not None:
        parts = [(grp, *_wire_upcom(xw, slot, m, s, grp, seed, survivor,
                                    robust, shard)) for grp in wire]
        if len(parts) == 1 and parts[0][0].whole:
            _, x_bar, covered = parts[0]
        else:
            x_bar = torch.empty(d, dtype=torch.float32, device=xw.device)
            if survivor:
                covered = torch.empty(d, dtype=torch.bool, device=xw.device)
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
    elif robust is not None and shard is not None:
        x_bar, covered = shard.robust_exchange(
            lambda a, b: xm[:, a:b], d, lambda t, cols: torch.remainder(
                t - band[cols].to(torch.int64), m), s, robust, survivor)
    elif robust is not None:
        x_bar, cnt = uplink.robust_sum(xm, slot, band, m, s, kind=robust[0],
                                       k=robust[1])
        if survivor:
            covered = cnt > 0
        del cnt
    else:
        def upcom(counts):
            if xm.shape[0] == 0:
                z = torch.zeros(d, dtype=torch.float32, device=xw.device)
                return (z, torch.zeros_like(z)) if counts else z
            return uplink.masked_sum(xm, slot, band, m, s, counts=counts)

        if survivor:
            # comm_ws._survivor_bar, in place on the sum
            x_bar, cnt = _over_ranks(shard, upcom(True))
            covered = cnt > 0
            x_bar.div_(cnt.clamp_(min=1.0))
            del cnt
        else:
            x_bar = _over_ranks(shard, upcom(False))
    if xm.shape[0]:
        uplink.h_update(xm, hm, x_bar, slot, band, m, s, scale, down=down,
                        covered=covered)
    return x_bar


def _demote(slot: torch.Tensor, arrived: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """``slot`` with the rows that did not arrive set to -1."""
    if arrived is None:
        return slot
    return torch.where(arrived.to(slot.device), slot, -1).to(torch.int32)


def cyclic_comm(xw: torch.Tensor, hw: torch.Tensor, slot: torch.Tensor,
                band: torch.Tensor, c: int, s: int, scale: float,
                down: Optional[torch.Tensor] = None,
                arrived: Optional[torch.Tensor] = None,
                correct: bool = True,
                robust: Optional[Tuple[str, int]] = None,
                wire: Optional[Tuple[WireGroup, ...]] = None,
                wire_seed: int = 0,
                wire_down: bool = False,
                tall: Sequence[Tuple[int, int, int, str]] = ()
                ) -> torch.Tensor:
    """UpCom + control-variate update + DownCom of the cyclic template, in
    place on the workspaces; returns the rebuilt server model ``x_bar``
    over the kernels' columns.

    ``slot`` ``(n,)`` int32 is each client's template column (-1 when idle),
    ``down`` ``(n,)`` int32 the DownCom rows (``None``: every row).
    ``band`` covers the first ``d = band.numel()`` columns, which the
    kernels take (all of them unless tall leaves lie after them).

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
    is the f32 path.

    ``tall`` lists the tall-and-thin leaves laid after the kernels'
    columns, as ``(reference leaf index, offset, D, wire kind)``: each
    takes the dense closed form (``_dense_cyclic_leaf``) with its own wire
    draws, and the kernels never touch its columns.  The reference's
    ``cyclic_comm(impl="pallas")``, its kernel path ``comm_ws._pallas_comm``
    beside the fallback list; ``cyclic_comm_leaves`` is its ``impl="ws"``
    and ``impl="dense"``."""
    survivor = arrived is not None and correct
    slot = _demote(slot, arrived)
    seed = int(wire_seed) & 0xFFFFFFFF
    x_bar = _kernel_comm(xw, hw, slot, band, c, s, scale, down, survivor,
                         robust, wire, seed, wire_down)
    if tall:
        sl = slot.to(torch.int64)
        dn = None if down is None else down.to(torch.bool)
        for li, o, D, kind in tall:
            xl, hl = xw[:, o:o + D], hw[:, o:o + D]
            xn, hn = _dense_cyclic_leaf(
                xl, hl, sl, c, s, scale, dn, sanitize=arrived is not None,
                survivor=survivor, quant=_leaf_quant(kind, seed, li, D),
                down_quant=(_down_quant(kind, seed, li, D) if wire_down
                            else None), robust=robust)
            xl.copy_(xn)
            hl.copy_(hn)
    return x_bar


def blocked_comm(xw: torch.Tensor, hw: torch.Tensor, off: int,
                 slot_of: torch.Tensor, band: torch.Tensor, c: int, s: int,
                 scale: float, down: Optional[torch.Tensor] = None,
                 arrived: Optional[torch.Tensor] = None,
                 correct: bool = True,
                 robust: Optional[Tuple[str, int]] = None,
                 wire: Optional[Tuple[WireGroup, ...]] = None,
                 wire_seed: int = 0,
                 wire_down: bool = False) -> torch.Tensor:
    """UpCom + control-variate update + DownCom of the blocked template
    (``uplink="block_rs"``), in place on the workspaces; returns
    ``x_bar``.  ``slot_of`` ``(n,)`` int is each client's cohort slot in
    ``[0, c)`` (-1 idle), ``off`` the round's shift in ``[0, c)`` and
    ``band`` the block band (``block_band``).  Ownership is ``(block(k) -
    slot_of - off) mod c < s``: every coordinate has exactly ``s`` owners,
    all of them cohort members, at any leaf size.  ``down``, ``arrived``,
    ``correct``, ``robust`` and the wire are ``cyclic_comm``'s.  The
    reference's ``blocked_comm(impl="pallas")``; ``blocked_comm_leaves`` is
    its ``impl="ws"`` and ``impl="dense"``."""
    slot = _demote(blocked_slot(slot_of.to(xw.device), off, c), arrived)
    return _kernel_comm(xw, hw, slot, band, c, s, scale, down,
                        arrived is not None and correct, robust, wire,
                        int(wire_seed) & 0xFFFFFFFF, wire_down)


# --------------------------------------------------------------------------
# the shard engine: a rank's rows, the ranks' partials summed
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Shard:
    """One rank's side of a comm step (``shard_comm``): its
    ``sharding.RankRows`` and the round's ``(m,)`` int64 owner table,
    the global row holding each kernel slot value after the arrivals'
    demotion (-1 where none does)."""

    group: "object"
    client_of: torch.Tensor

    @property
    def row0(self) -> int:
        return self.group.row0

    def robust_exchange(self, vals, d: int, slots_at, s: int,
                        robust: Tuple[str, int], survivor: bool):
        """The robust combine over ranks (the reference's ``(s, d)``
        owner-value exchange), in column chunks: each rank fills row ``t``
        of a chunk's ``(s, w)`` stack with the values of the owners at
        shift ``t`` it hosts (``vals(a, b)``: its rows' f32 values of
        columns ``[a, b)``; ``slots_at(t, cols)``: the kernel slot value
        owning each column at shift ``t``) and zeros elsewhere, one sum
        replicates the stack, and ``robust.robust_combine_stack`` combines
        it with the live owners as its mask.  Returns ``(x_bar, covered)``
        over the ``d`` columns, ``covered`` ``None`` unless ``survivor``.
        An exchanged ``-0`` arrives as ``+0``."""
        g = self.group
        dev = self.client_of.device
        x_bar = torch.empty(d, dtype=torch.float32, device=dev)
        covered = (torch.empty(d, dtype=torch.bool, device=dev)
                   if survivor else None)
        for cols in ref.column_chunks(d):
            w = cols.stop - cols.start
            v = vals(cols.start, cols.stop) if g.local else None
            stack = torch.zeros(s, w, dtype=torch.float32, device=dev)
            ok = torch.empty(s, w, dtype=torch.bool, device=dev)
            for t in range(s):
                own = self.client_of[slots_at(t, cols)]
                ok[t] = own >= 0
                if v is not None:
                    loc = (own >= g.row0) & (own < g.stop)
                    rr = (own - g.row0).clamp_(0, g.local - 1)
                    stack[t] = torch.where(loc, v.gather(0, rr[None])[0],
                                           0.0)
            del v
            g.all_reduce(stack)
            bar, cnt = robust_mod.robust_combine_stack(stack, ok, *robust)
            x_bar[cols] = bar
            if survivor:
                covered[cols] = cnt > 0
        return x_bar, covered


def _over_ranks(shard: Optional[_Shard], partial):
    """A rank's UpCom partial (a tensor, or the survivor's ``(num, cnt)``)
    summed over the ranks in place; itself without ``shard``."""
    if shard is None:
        return partial
    if isinstance(partial, tuple):
        return tuple(shard.group.all_reduce(t) for t in partial)
    return shard.group.all_reduce(partial)


def _client_table(slot: torch.Tensor, m: int) -> torch.Tensor:
    """``(m,)`` int64: the row whose ``slot`` holds each value in ``[0,
    m)``, -1 where no row does (idle and demoted rows hold none)."""
    n = slot.shape[0]
    sl = slot.to(torch.int64)
    cell = torch.where((sl >= 0) & (sl < m), sl, m)
    table = torch.full((m + 1,), -1, dtype=torch.int64, device=slot.device)
    table[cell] = torch.arange(n, dtype=torch.int64, device=slot.device)
    return table[:m]


def _shard_tall_leaf(xl, hl, sl, shard: _Shard, c: int, s: int, scale,
                     down, survivor, quant, down_quant, robust):
    """One tall-and-thin cyclic leaf (``D s < c``) of a rank's rows
    (``comm_ws._shard_comm``'s non-kernel leaves): the owned columns
    ``k + t D`` as a predicate, the rank's owner sum (from +0, rows in
    order; ``1/s`` folded per rank) or the survivor's numerator and count
    summed over the ranks, or the owner-value exchange under ``robust``;
    then ``_finish_leaf``."""
    n_loc, D = xl.shape
    dev = xl.device
    kk = torch.arange(D, dtype=torch.int64, device=dev)
    sl2 = sl.to(torch.int64)[:, None]
    owned = (sl2 >= 0) & (sl2 < D * s) & (
        torch.remainder(sl2, D) == kk[None, :])
    xf = xl.to(torch.float32)
    xq = xf if quant is None or n_loc == 0 else quant(xf)
    cov = None
    if robust is not None:
        x_bar, cov = shard.robust_exchange(
            lambda a, b: xq[:, a:b], D, lambda t, cols: kk[cols] + t * D, s,
            robust, survivor)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        num = torch.zeros(D, dtype=torch.float32, device=dev)
        cnt = torch.zeros(D, dtype=torch.float32, device=dev)
        for i in range(n_loc):
            num = num + torch.where(owned[i], xq[i], zero)
            cnt = cnt + owned[i].to(torch.float32)
        g = shard.group
        if survivor:
            x_bar, cov = _survivor_bar(g.all_reduce(num), g.all_reduce(cnt))
        else:
            x_bar = g.all_reduce(ref._div(num, s))
    if down_quant is not None:
        x_bar = down_quant(x_bar)
    dn = None if down is None else down.to(torch.bool)
    return _finish_leaf(xl, hl, xf, x_bar, owned, scale, dn, cov)


def shard_comm(xw: torch.Tensor, hw: torch.Tensor, slot: torch.Tensor,
               band: torch.Tensor, m: int, s: int, scale: float, *,
               group, down: Optional[torch.Tensor] = None,
               arrived: Optional[torch.Tensor] = None,
               correct: bool = True,
               robust: Optional[Tuple[str, int]] = None,
               wire: Optional[Tuple[WireGroup, ...]] = None,
               wire_seed: int = 0, wire_down: bool = False,
               tall: Sequence[Tuple[int, int, int, str]] = ()
               ) -> torch.Tensor:
    """The comm step of a rank's rows under data parallelism (the
    reference's shard-resident ``comm_ws._shard_comm`` on the data axis),
    in place on the rank's workspaces; returns ``x_bar`` over the kernels'
    columns, the same on every rank.

    ``group`` is the rank's ``sharding.RankRows``; ``xw``/``hw`` its
    ``(group.local, d_total)`` rows.  ``slot`` ``(n,)`` int32 holds every
    client's kernel slot (``cyclic_comm``'s template columns, or
    ``blocked_slot``'s folded slots for the blocked template, with
    ``band`` the matching band), ``down`` ``(n,)`` int32 and ``arrived``
    ``(n,)`` bool are global too; the rest is ``cyclic_comm``'s.

    The kernels run on the rank's rows only.  The mean rebuild sums the
    ranks' ``1/s``-folded ``masked_sum`` partials (one d-sized sum; one
    per wire kind group); the survivor rebuild sums the numerators and
    the counts and divides after; the DownCom quantizer runs on the
    summed ``x_bar``, the same on every rank; the robust combines, which
    do not decompose over ranks, exchange the owner values in ``(s,
    chunk)`` stacks (``_Shard.robust_exchange``); tall leaves sum their
    partials per leaf.  No collective is sized by the population.  The
    UpCom payloads draw with the rows' global ids, so the int codes are
    those of the one-process step.  At ``s = 2`` every coordinate's two
    owner partials add once and the step is the one-process step bitwise;
    at ``s >= 3`` the ranks' partials reassociate the owner sum."""
    n = slot.shape[0]
    if n != group.n or xw.shape[0] != group.local:
        raise ValueError(f"rank {group.rank} holds {group.local} of "
                         f"{group.n} rows; got a workspace of "
                         f"{xw.shape[0]} and {n} slots")
    survivor = arrived is not None and correct
    slot = _demote(slot, arrived)
    seed = int(wire_seed) & 0xFFFFFFFF
    shard = _Shard(group, _client_table(slot, m))
    rows = slice(group.row0, group.stop)
    sl_loc = slot[rows]
    dn_loc = None if down is None else down[rows]
    x_bar = _kernel_comm(xw, hw, sl_loc, band, m, s, scale, dn_loc,
                         survivor, robust, wire, seed, wire_down, shard)
    for li, o, D, kind in tall:
        xl, hl = xw[:, o:o + D], hw[:, o:o + D]
        xn, hn = _shard_tall_leaf(
            xl, hl, sl_loc, shard, m, s, scale, dn_loc, survivor,
            _leaf_quant(kind, seed, li, D, group.row0),
            _down_quant(kind, seed, li, D) if wire_down else None, robust)
        xl.copy_(xn)
        hl.copy_(hn)
    return x_bar


# --------------------------------------------------------------------------
# the plain implementations: impl="ws" and impl="dense"
# --------------------------------------------------------------------------

COMM_IMPLS = ("ws", "dense")

Leaves = Union[torch.Tensor, Dict[str, torch.Tensor]]


@functools.lru_cache(maxsize=None)
def _cyclic_leaf_tables_np(D: int, c: int, s: int):
    """(owner-column table (s, D), band (D,), tall?) for one leaf
    (``comm_ws._cyclic_leaf_tables_np``).

    cols[t, k] = the t-th template column owning coordinate k: the cyclic
    band ``(s k + t) mod c`` when ``D s >= c`` (paper Fig. 1 left), else
    the tall-and-thin columns ``k + t D`` (all < D s <= c; columns past
    ``D s`` own nothing).  band[k] = (s k) mod c drives the ownership
    predicate of the cyclic regime."""
    k = np.arange(D, dtype=np.int64)
    tall = D * s < c
    if tall:
        cols = np.stack([k + t * D for t in range(s)])
    else:
        cols = np.stack([(s * k + t) % c for t in range(s)])
    band = ((s * k) % c).astype(np.int32)
    return cols.astype(np.int32), band, tall


@functools.lru_cache(maxsize=None)
def _cyclic_band_counts_np(D: int, c: int, s: int) -> np.ndarray:
    """(c,) int64: the coordinates of a leaf of ``D`` per cyclic band
    value ``(s k) mod c`` (``comm_ws._cyclic_band_counts_np``, not tall),
    in closed form: ``k`` and ``k mod c`` have the same band."""
    r = np.arange(c, dtype=np.int64)
    per = D // c + (r < D % c)
    return np.bincount((s * r) % c, weights=per, minlength=c).astype(
        np.int64)


@functools.lru_cache(maxsize=None)
def _block_band_counts_np(D: int, m: int) -> np.ndarray:
    """(m,) int64: the coordinates of a leaf of ``D`` per block ``k //
    ceil(D / m)`` (``comm_ws._block_band_counts_np``), the last ragged."""
    chunk = -(-D // m)
    return np.clip(D - chunk * np.arange(m, dtype=np.int64), 0, chunk)


def uncovered_coords(template: str, dims: Sequence[int], m: int, s: int,
                     slot) -> int:
    """The coordinates with no surviving owner this round
    (``comm_ws.uncovered_coords``), on the host.

    ``slot`` ``(n,)`` int is each client's final slot in the comm step
    (-1 idle or not arrived): the template column under ``"cyclic"``, the
    folded ``(-(slot_of + off)) mod c`` under ``"blocked"``.  Under the
    survivor rebuild exactly these coordinates keep x and h bitwise.  The
    count takes the ``(m,)`` occupancy of the slot values and each leaf's
    band counts; a tall-and-thin cyclic leaf (``D s < m``) its owner-column
    table (``_cyclic_leaf_tables_np``)."""
    if template not in ("cyclic", "blocked"):
        raise ValueError(f"unknown template {template!r}")
    slot = np.asarray(slot, np.int64)
    pres = np.zeros(m + 1, bool)
    pres[np.where(slot >= 0, slot, m)] = True
    pres = pres[:m]
    cov_band = np.zeros(m, bool)
    if template == "cyclic":
        # band b is covered iff a column (b + t) mod m, t < s, arrived
        for t in range(s):
            cov_band |= np.roll(pres, -t)
    else:
        # block b is covered iff a slot (t - b) mod m, t < s, arrived
        pres_rev = np.roll(pres[::-1], 1)  # pres_rev[b] = pres[(-b) % m]
        for t in range(s):
            cov_band |= np.roll(pres_rev, t)
    total = 0
    for D in dims:
        if template == "cyclic" and D * s < m:
            cols, _, _ = _cyclic_leaf_tables_np(D, m, s)
            total += D - int(pres[cols].any(axis=0).sum())
        else:
            cnt = (_cyclic_band_counts_np(D, m, s) if template == "cyclic"
                   else _block_band_counts_np(D, m))
            total += int(cnt[~cov_band].sum())
    return total


def _wrapped_lt(diff: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """``diff mod m < s`` for ``diff in (-m, m)`` as two compares."""
    return ((diff >= 0) & (diff < s)) | (diff < s - m)


def _wrapped_owned(slot2: torch.Tensor, band: torch.Tensor, m: int,
                   s: int) -> torch.Tensor:
    """Kernel-convention ownership ``(slot + band) mod m < s`` as two
    compares, idle rows (``slot < 0``) excluded.  ``slot2`` broadcasts
    against ``band``; both in ``[0, m)``."""
    sb = slot2 + band
    return (slot2 >= 0) & (slot2 < m) & (
        (sb < s) | ((sb >= m) & (sb < m + s)))


def _downcom(xl: torch.Tensor, x_bar: torch.Tensor,
             down: Optional[torch.Tensor],
             covered: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DownCom of one leaf: ``down`` rows (all when None) receive ``x_bar``
    in storage dtype; every other row keeps its ``x`` bit-exactly.
    ``covered`` additionally gates per coordinate: columns with no arrived
    owner keep their ``x`` bit-exactly."""
    n, D = xl.shape[0], x_bar.shape[0]
    bar = x_bar.to(xl.dtype)[None]
    x2 = xl.reshape(n, D)
    if covered is None:
        if down is None:
            return bar.expand(n, D).clone().reshape(xl.shape)
        return torch.where(down[:, None], bar, x2).reshape(xl.shape)
    gate = covered[None, :] if down is None else (down[:, None]
                                                  & covered[None, :])
    return torch.where(gate, bar, x2).reshape(xl.shape)


def _finish_leaf(xl, hl, xf, x_bar, owned, scale, down=None, covered=None):
    """The h update and DownCom of one leaf: ``h + scale (x_bar - x)`` in
    f32 where ``owned``, cast back to h's storage dtype; ``covered`` gates
    the DownCom per coordinate (the h update needs no gate: an uncovered
    coordinate has no arrived owner, so ``owned`` is false there)."""
    return (_downcom(xl, x_bar, down, covered),
            _h_new(hl, xf, x_bar, owned, scale))


def _h_new(hl, xf, x_bar, owned, scale):
    """``h + scale * sel(x_bar - x)`` in f32, cast to h's storage type,
    where ``sel`` is ``owned``'s select (bool) or product (f32 0/1 mask):
    one ``(n, D)`` temporary, updated in place.  The product commutes with
    ``scale`` here: ``(scale * q) * t`` and ``(q * t) * scale`` are the same
    f32 value for ``q`` in {0, 1} and ``scale > 0``, signed zeros and NaN
    included, and so are ``h + t`` and ``t + h``."""
    n, D = xf.shape
    t = x_bar[None] - xf
    if owned.dtype == torch.bool:
        t.masked_fill_(~owned, 0.0)
    else:
        t.mul_(owned)
    t.mul_(scale)
    t.add_(hl.reshape(n, D).to(torch.float32))
    return t.to(hl.dtype).reshape(hl.shape)


def _survivor_bar(num: torch.Tensor, cnt: torch.Tensor):
    """``x_bar = num / max(cnt, 1)`` and the covered mask: the per-
    coordinate 1/(arrived owner count) rebuild."""
    return num / cnt.clamp(min=1.0), cnt > 0


def _leaf_quant(kind: str, seed: int, li: int, D: int, row0: int = 0):
    """Quantize-dequantize one leaf's ``(rows, D)`` f32 payload at ``kind``
    (None for the f32 wire), keyed on the round seed folded with the leaf
    index, the row id ``row0 + row`` and the leaf coordinate
    (``comm_ws._leaf_quant``; ``row0`` is a rank's first global row)."""
    if kind == "f32":
        return None
    sl = wire_mod.fold_seed(seed, li)

    def quant(xf):
        rid = torch.arange(row0, row0 + xf.shape[0], dtype=torch.int64,
                           device=xf.device)[:, None]
        kk = torch.arange(D, dtype=torch.int64, device=xf.device)
        return wire_mod.quantize(xf, kind, sl, rid, kk)

    return quant


def _down_quant(kind: str, seed: int, li: int, D: int):
    """The DownCom quantizer of one leaf: one shared quantization of
    ``x_bar`` keyed on the pseudo row ``wire.DOWN_ROW``
    (``comm_ws._down_quant``)."""
    if kind == "f32":
        return None
    sl = wire_mod.fold_seed(seed, li)

    def quant(xb):
        kk = torch.arange(D, dtype=torch.int64, device=xb.device)
        return wire_mod.quantize(xb[None, :], kind, sl, wire_mod.DOWN_ROW,
                                 kk)[0]

    return quant


def _dense_cyclic_leaf(xl, hl, slot, c: int, s: int, scale, down=None,
                       sanitize=False, survivor=False, quant=None,
                       down_quant=None, robust=None):
    """One leaf of the reference's dense comm step
    (``comm_ws._dense_cyclic_leaf``): the ``(n, D)`` ownership mask from
    ``masks.mask_from_permutation`` (both template regimes), the masked
    sum over every row, the ``1/s`` (or survivor) rebuild, the masked h
    update and the DownCom.  ``sanitize`` zeroes idle rows first (the mask
    multiplies: ``NaN * 0`` is NaN); ``quant`` quantizes the UpCom payload
    after it, ``down_quant`` the rebuilt broadcast.  ``robust`` combines
    the ``(n, D)`` payload with the mask as its validity mask."""
    n = xl.shape[0]
    D = xl[0].numel()
    sl = slot[:, None]
    q = masks.mask_from_permutation(
        torch.arange(c, dtype=torch.int32, device=xl.device), D, c,
        s).to(torch.bool)  # (D, c) template
    qf = (q.T[slot.clamp(0, c - 1)] & (sl >= 0)
          & (sl < c)).to(torch.float32)
    xf = xl.reshape(n, D).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=xl.device)
    if sanitize:
        xf = torch.where(sl >= 0, xf, zero)
    xq = xf if quant is None else quant(xf)
    if robust is not None:
        x_bar, rcnt = robust_mod.robust_combine_stack(xq, qf > 0, *robust)
        covered = (rcnt > 0) if survivor else None
    elif survivor:
        x_bar, covered = _survivor_bar((xq * qf).sum(dim=0), qf.sum(dim=0))
    else:
        x_bar, covered = ref._div((xq * qf).sum(dim=0), s), None
    if down_quant is not None:
        x_bar = down_quant(x_bar)
    return (_downcom(xl, x_bar, down, covered),
            _h_new(hl, xf, x_bar, qf, scale))


def _dense_blocked_leaf(xl, hl, slot, m: int, s: int, scale, down=None,
                        sanitize=False, survivor=False, quant=None,
                        down_quant=None, robust=None):
    """One leaf of the reference's dense blocked comm step
    (``comm_ws._dense_blocked_leaf``): the materialized ``(n, D)``
    ownership ``(slot + block(k)) mod m < s`` (evaluated per block, then
    repeated over the block's coordinates), the masked sum over every row,
    the ``1/s`` (or survivor) rebuild, the masked h update and the
    DownCom; ``sanitize``, ``quant``, ``down_quant`` and ``robust`` as in
    ``_dense_cyclic_leaf``."""
    n = xl.shape[0]
    D = xl[0].numel()
    chunk = -(-D // m)
    nb = -(-D // chunk)
    sl = slot[:, None]
    jb = torch.arange(nb, dtype=torch.int64, device=xl.device)[None, :]
    own_nb = (sl >= 0) & (torch.remainder(sl + jb, m) < s)
    qf = own_nb.repeat_interleave(chunk, dim=1)[:, :D].to(torch.float32)
    del own_nb
    xf = xl.reshape(n, D).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=xl.device)
    if sanitize:
        xf = torch.where(sl >= 0, xf, zero)
    xq = xf if quant is None else quant(xf)
    if robust is not None:
        x_bar, rcnt = robust_mod.robust_combine_stack(xq, qf > 0, *robust)
        covered = (rcnt > 0) if survivor else None
    elif survivor:
        x_bar, covered = _survivor_bar((xq * qf).sum(dim=0), qf.sum(dim=0))
    else:
        x_bar, covered = ref._div((xq * qf).sum(dim=0), s), None
    if down_quant is not None:
        x_bar = down_quant(x_bar)
    return (_downcom(xl, x_bar, down, covered),
            _h_new(hl, xf, x_bar, qf, scale))


def _ws_cyclic_leaf(xl, hl, slot, client_of, col_ok, c: int, s: int,
                    scale, down=None, survivor=False, quant=None,
                    down_quant=None, robust=None):
    """One leaf of the reference's sparse comm step (``impl="ws"``,
    ``meshed=False``): ``s`` owner-row gathers per coordinate through
    ``client_of`` (the round's column-to-row table), summed in owner order
    from +0, the ``1/s`` (or survivor) rebuild, then ``_finish_leaf``.
    ``col_ok`` (faulted rounds) gates the columns whose owner did not
    arrive.  ``robust`` combines the ``(s, D)`` owner stack with ``col_ok``
    as its validity mask, and with none (``ok=None``, the static window)
    on fault-free rounds; the reference's gather-free stack of a fault-free
    leaf that is not tall holds the same values as the gathers."""
    n = xl.shape[0]
    D = xl[0].numel()
    dev = xl.device
    cols, band, tall = _cyclic_leaf_tables_np(D, c, s)
    xf = xl.reshape(n, D).to(torch.float32)
    xq = xf if quant is None else quant(xf)
    sl = slot[:, None]
    if tall:
        kj = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
        owned = (sl < D * s) & (torch.remainder(sl, D) == kj)
    else:
        owned = _wrapped_lt(sl - torch.from_numpy(band).to(dev)[None, :],
                            c, s)
    owned = owned & (sl >= 0)
    cols_t = torch.from_numpy(cols).to(dev, torch.int64)
    vals = xq.gather(0, client_of[cols_t])  # (s, D) owner rows' payloads
    ok = None if col_ok is None else col_ok[cols_t]
    if robust is not None:
        x_bar, rcnt = robust_mod.robust_combine_stack(vals, ok, *robust)
        cov = (rcnt > 0) if survivor else None
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if ok is not None:
            vals = torch.where(ok, vals, zero)
        num = torch.zeros(D, dtype=torch.float32, device=dev)
        for t in range(s):
            num = num + vals[t]
        if survivor:
            x_bar, cov = _survivor_bar(num, ok.to(torch.float32).sum(dim=0))
        else:
            x_bar, cov = ref._div(num, s), None
    if down_quant is not None:
        x_bar = down_quant(x_bar)
    return _finish_leaf(xl, hl, xf, x_bar, owned, scale, down, cov)


def _ws_blocked_leaf(xl, hl, slot, client_of, col_ok, m: int, s: int,
                     scale, down=None, survivor=False, quant=None,
                     down_quant=None, robust=None):
    """One leaf of the reference's sparse blocked comm step (``blocked_comm
    (impl="ws", meshed=False)``): block ``j``'s owner at shift ``t`` is the
    client in slot ``(t - j) mod m``, so the UpCom is ``s`` contiguous
    chunk gathers added from +0 in shift order (the full blocks, then the
    ragged tail), the ``1/s`` (or survivor) rebuild, then ``_finish_leaf``
    with the block-granular ownership repeated over each block.  ``robust``
    stacks the ``s`` gathers with ``col_ok`` (all true on fault-free
    rounds) as their validity."""
    n = xl.shape[0]
    D = xl[0].numel()
    dev = xl.device
    chunk = -(-D // m)
    nf, tail = divmod(D, chunk)
    nb = nf + (1 if tail else 0)
    xf = xl.reshape(n, D).to(torch.float32)
    xq = xf if quant is None else quant(xf)
    sl = slot[:, None]
    jb = torch.arange(nb, dtype=torch.int64, device=dev)[None, :]
    owned = _wrapped_owned(sl, jb, m, s).repeat_interleave(
        chunk, dim=1)[:, :D]
    jf = torch.arange(nf, dtype=torch.int64, device=dev)
    xm = xq[:, :nf * chunk].reshape(n, nf, chunk)
    faulted = col_ok is not None
    cov = None
    if robust is not None:
        vals_l, ok_l = [], []
        for t in range(s):
            cf = torch.remainder(t - jf, m)
            v = xm[client_of[cf], jf].reshape(-1)
            okv = (col_ok[cf] if faulted
                   else torch.ones(nf, dtype=torch.bool, device=dev))
            okv = okv.repeat_interleave(chunk)
            if tail:
                ct = (t - nf) % m
                v = torch.cat([v, xq[client_of[ct], nf * chunk:]])
                okt = (col_ok[ct] if faulted
                       else torch.ones((), dtype=torch.bool, device=dev))
                okv = torch.cat([okv, okt.expand(tail)])
            vals_l.append(v)
            ok_l.append(okv)
        x_bar, rcnt = robust_mod.robust_combine_stack(
            torch.stack(vals_l), torch.stack(ok_l), *robust)
        del vals_l, ok_l
        if survivor:
            cov = rcnt > 0
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        acc = torch.zeros(nf, chunk, dtype=torch.float32, device=dev)
        acc_t = torch.zeros(tail, dtype=torch.float32, device=dev)
        cnt_f = torch.zeros(nf, dtype=torch.float32, device=dev)
        cnt_t = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(s):
            cf = torch.remainder(t - jf, m)
            rows = xm[client_of[cf], jf]
            if faulted:
                ok = col_ok[cf]
                acc = acc + torch.where(ok[:, None], rows, zero)
                cnt_f = cnt_f + ok.to(torch.float32)
            else:
                acc = acc + rows
            del rows
            if tail:
                ct = (t - nf) % m
                row_t = xq[client_of[ct], nf * chunk:]
                if faulted:
                    ok_t = col_ok[ct]
                    acc_t = acc_t + torch.where(ok_t, row_t, zero)
                    cnt_t = cnt_t + ok_t.to(torch.float32)
                else:
                    acc_t = acc_t + row_t
        num = torch.cat([acc.reshape(-1), acc_t]) if tail else acc.reshape(-1)
        del acc
        if survivor:
            cnt = cnt_f.repeat_interleave(chunk)
            if tail:
                cnt = torch.cat([cnt, cnt_t.expand(tail)])
            x_bar, cov = _survivor_bar(num, cnt)
        else:
            x_bar = ref._div(num, s)
    if down_quant is not None:
        x_bar = down_quant(x_bar)
    return _finish_leaf(xl, hl, xf, x_bar, owned, scale, down, cov)


def _leaf_items(leaves: Leaves):
    """``[(name, tensor)]`` in the reference's leaf order: a tensor is one
    leaf; a dict's leaves go in sorted key order, as ``jax.tree`` flattens
    a dict."""
    if isinstance(leaves, torch.Tensor):
        return [(None, leaves)]
    return [(k, leaves[k]) for k in sorted(leaves)]


def iter_comm_leaves(template: str, xs, hs, slot: torch.Tensor, c: int,
                     s: int, scale: float, impl: str = "ws", *,
                     down: Optional[torch.Tensor] = None,
                     arrived: Optional[torch.Tensor] = None,
                     correct: bool = True,
                     wire: Optional[str] = None,
                     wire_seed: int = 0,
                     wire_down: bool = False,
                     robust=None):
    """The plain comm step leaf by leaf: yields ``(name, x_new, h_new)``
    for each of the ``[(name, x leaf)]``/``[(name, h leaf)]`` pairs ``xs``
    and ``hs``, taken in the reference's leaf order (the i-th pair is leaf
    i, whose index keys its wire draws).  ``template`` is ``"cyclic"``
    (``slot`` the template columns) or ``"blocked"`` (``slot`` the kernel
    slots of ``blocked_slot``); the rest is ``cyclic_comm_leaves``'.  A
    caller that writes each leaf back before taking the next holds one
    leaf's results at a time."""
    if impl not in COMM_IMPLS:
        raise ValueError(f"unknown comm impl {impl!r}; want one of "
                         f"{COMM_IMPLS} (the kernel path is cyclic_comm)")
    if template not in ("cyclic", "blocked"):
        raise ValueError(f"unknown template {template!r}")
    if [k for k, _ in xs] != [k for k, _ in hs]:
        raise ValueError("x and h must have the same leaves")
    n = xs[0][1].shape[0]
    dev = xs[0][1].device
    slot = slot.to(device=dev, dtype=torch.int64)
    faulted = arrived is not None
    survivor = faulted and correct
    if faulted:
        slot = torch.where(arrived.to(device=dev, dtype=torch.bool), slot,
                           -1)
    if down is not None:
        down = down.to(device=dev, dtype=torch.bool)
    policy = wire if wire_mod.is_wire(wire) else None
    seed = int(wire_seed) & 0xFFFFFFFF
    wdown = bool(wire_down) and policy is not None
    client_of = col_ok = None
    if impl == "ws":
        # column (blocked: slot) -> client row of this round; idle rows
        # write to the dropped overflow cell, and a column nobody holds
        # reads row 0 (col_ok gates those on faulted rounds)
        valid = (slot >= 0) & (slot < c)
        cell = torch.where(valid, slot, c)
        client_of = torch.zeros(c + 1, dtype=torch.int64, device=dev)
        client_of[cell] = torch.arange(n, dtype=torch.int64, device=dev)
        client_of = client_of[:c]
        if faulted:
            col_ok = torch.zeros(c + 1, dtype=torch.bool, device=dev)
            col_ok[cell] = True
            col_ok = col_ok[:c]
    for i, ((name, xl), (_, hl)) in enumerate(zip(xs, hs)):
        D = xl[0].numel()
        kind = wire_mod.resolve_kind(D, policy)
        quant = _leaf_quant(kind, seed, i, D)
        down_quant = _down_quant(kind, seed, i, D) if wdown else None
        if impl == "ws":
            leaf = _ws_cyclic_leaf if template == "cyclic" else \
                _ws_blocked_leaf
            xn, hn = leaf(xl, hl, slot, client_of, col_ok, c, s, scale,
                          down, survivor, quant, down_quant, robust)
        else:
            leaf = _dense_cyclic_leaf if template == "cyclic" else \
                _dense_blocked_leaf
            xn, hn = leaf(xl, hl, slot, c, s, scale, down, sanitize=faulted,
                          survivor=survivor, quant=quant,
                          down_quant=down_quant, robust=robust)
        yield name, xn, hn


def _collect(template, x, h, slot, c, s, scale, impl, **kw):
    out_x, out_h = {}, {}
    for name, xn, hn in iter_comm_leaves(template, _leaf_items(x),
                                         _leaf_items(h), slot, c, s, scale,
                                         impl, **kw):
        out_x[name], out_h[name] = xn, hn
    if isinstance(x, torch.Tensor):
        return out_x[None], out_h[None]
    return out_x, out_h


def cyclic_comm_leaves(x: Leaves, h: Leaves, slot: torch.Tensor, c: int,
                       s: int, scale: float, impl: str = "ws", *,
                       down: Optional[torch.Tensor] = None,
                       arrived: Optional[torch.Tensor] = None,
                       correct: bool = True,
                       wire: Optional[str] = None,
                       wire_seed: int = 0,
                       wire_down: bool = False,
                       robust=None) -> Tuple[Leaves, Leaves]:
    """The reference's ``comm_ws.cyclic_comm(impl="ws"|"dense",
    meshed=False)`` over client-stacked leaves: UpCom, control-variate
    update and DownCom of the cyclic template; returns new ``(x, h)`` of
    the same structure, shapes and storage types.

    ``x`` and ``h`` are an ``(n, ...)`` tensor or a dict of them (leaves
    in sorted key order, the reference's order, which keys each leaf's
    wire draw).  ``slot`` ``(n,)`` int is each client's template column,
    -1 when idle; ``scale`` is ``eta / gamma``.  The step runs in f32
    whatever the storage type.

    ``down`` ``(n,)`` bool: the DownCom rows (``None``: every row).
    ``arrived`` ``(n,)`` bool demotes the rows that did not arrive to idle;
    with ``correct`` the rebuild divides by the per-coordinate count of
    arrived owners and coordinates no arrived row owns keep x and h
    untouched; without it the ``1/s`` rebuild stays (the wait-all
    control).  ``wire`` (a ``wire.WIRE_POLICIES`` policy) quantizes the
    UpCom payload with the round's uint32 ``wire_seed``; ``wire_down`` also
    quantizes ``x_bar`` before the DownCom.  ``robust``
    (``robust.normalize_robust``'s spec; ``None`` is the mean path)
    replaces the rebuild by the trimmed mean or median of the arrived
    owner values, on the dequantized wire values; with ``correct`` the
    coordinates without an arrived owner keep x and h.

    ``impl="ws"`` gathers the ``s`` owner rows of every coordinate
    (``O(s D)`` reads); ``impl="dense"`` materializes the ``(n, D)`` mask,
    the reference's ground truth.  The two agree bitwise at ``s = 2`` but
    for the sign of zeros, and to f32 reassociation at ``s >= 3``.  Both
    take a tall-and-thin leaf (``D s < c``) by its own columns."""
    return _collect("cyclic", x, h, slot, c, s, scale, impl, down=down,
                    arrived=arrived, correct=correct, wire=wire,
                    wire_seed=wire_seed, wire_down=wire_down, robust=robust)


def blocked_comm_leaves(x: Leaves, h: Leaves, off: int, n: int, s: int,
                        scale: float, impl: str = "ws", *,
                        c: Optional[int] = None,
                        slot_of: Optional[torch.Tensor] = None,
                        down: Optional[torch.Tensor] = None,
                        arrived: Optional[torch.Tensor] = None,
                        correct: bool = True,
                        wire: Optional[str] = None,
                        wire_seed: int = 0,
                        wire_down: bool = False,
                        robust=None) -> Tuple[Leaves, Leaves]:
    """The reference's ``comm_ws.blocked_comm(impl="ws"|"dense",
    meshed=False)`` over client-stacked leaves: the blocked template's
    UpCom, control-variate update and DownCom; returns new ``(x, h)`` as
    ``cyclic_comm_leaves`` does.

    Each leaf chunks into ``m = c`` blocks of ``ceil(D / m)`` (the last
    ragged); client ``i`` in cohort slot ``slot_of[i]`` (-1 idle) owns the
    blocks ``(slot_of[i] + off) .. (slot_of[i] + off + s - 1) mod m``, the
    round's shift ``off`` in ``[0, m)``.  ``c=None`` is full
    participation (``m = n``, slot ``i`` for client ``i``); ``c < n``
    needs ``slot_of``.  ``impl="ws"`` reads ``s`` contiguous chunks per
    block; ``impl="dense"`` materializes the ``(n, D)`` mask.  The rest is
    ``cyclic_comm_leaves``'."""
    m = n if c is None else int(c)
    if slot_of is None:
        if m != n:
            raise ValueError(f"blocked_comm_leaves with c={m} < n={n} needs "
                             "slot_of (the per-client cohort slots)")
        slot_of = torch.arange(n, dtype=torch.int64)
    slot = blocked_slot(torch.as_tensor(slot_of), off, m)
    return _collect("blocked", x, h, slot, m, s, scale, impl, down=down,
                    arrived=arrived, correct=correct, wire=wire,
                    wire_seed=wire_seed, wire_down=wire_down, robust=robust)
