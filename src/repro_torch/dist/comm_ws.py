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

``cyclic_comm_leaves`` is the reference's two plain implementations,
``impl="ws"`` (the sparse UpCom: ``s`` owner-row gathers per leaf, then one
fused h update and DownCom) and ``impl="dense"`` (the materialized
``(n, D)`` ownership mask, the reference's ground truth), over
client-stacked leaves in any float storage type, with the mean, survivor
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
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

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
    is the f32 path.  The reference's ``cyclic_comm(impl="pallas")``, its
    kernel path ``comm_ws._pallas_comm``; ``cyclic_comm_leaves`` is its
    ``impl="ws"`` and ``impl="dense"``."""
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
    n, D = xf.shape
    zero = torch.zeros((), dtype=torch.float32, device=xf.device)
    h_new = hl.reshape(n, D).to(torch.float32) + scale * torch.where(
        owned, x_bar[None] - xf, zero)
    return (_downcom(xl, x_bar, down, covered),
            h_new.to(hl.dtype).reshape(hl.shape))


def _survivor_bar(num: torch.Tensor, cnt: torch.Tensor):
    """``x_bar = num / max(cnt, 1)`` and the covered mask: the per-
    coordinate 1/(arrived owner count) rebuild."""
    return num / cnt.clamp(min=1.0), cnt > 0


def _leaf_quant(kind: str, seed: int, li: int, D: int):
    """Quantize-dequantize one leaf's ``(rows, D)`` f32 payload at ``kind``
    (None for the f32 wire), keyed on the round seed folded with the leaf
    index, the row and the leaf coordinate (``comm_ws._leaf_quant``)."""
    if kind == "f32":
        return None
    sl = wire_mod.fold_seed(seed, li)

    def quant(xf):
        rid = torch.arange(xf.shape[0], dtype=torch.int64,
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
    h_new = hl.reshape(n, D).to(torch.float32) + scale * qf * (
        x_bar[None] - xf)
    return (_downcom(xl, x_bar, down, covered),
            h_new.to(hl.dtype).reshape(hl.shape))


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


def _leaf_items(leaves: Leaves):
    """``[(name, tensor)]`` in the reference's leaf order: a tensor is one
    leaf; a dict's leaves go in sorted key order, as ``jax.tree`` flattens
    a dict."""
    if isinstance(leaves, torch.Tensor):
        return [(None, leaves)]
    return [(k, leaves[k]) for k in sorted(leaves)]


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
    for the sign of zeros, and to f32 reassociation at ``s >= 3``."""
    if impl not in COMM_IMPLS:
        raise ValueError(f"unknown comm impl {impl!r}; want one of "
                         f"{COMM_IMPLS} (the kernel path is cyclic_comm)")
    xs, hs = _leaf_items(x), _leaf_items(h)
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
        # column -> client row of this round; idle rows write to the
        # dropped overflow cell, and a column nobody holds reads row 0
        # (col_ok gates those on faulted rounds)
        valid = (slot >= 0) & (slot < c)
        cell = torch.where(valid, slot, c)
        client_of = torch.zeros(c + 1, dtype=torch.int64, device=dev)
        client_of[cell] = torch.arange(n, dtype=torch.int64, device=dev)
        client_of = client_of[:c]
        if faulted:
            col_ok = torch.zeros(c + 1, dtype=torch.bool, device=dev)
            col_ok[cell] = True
            col_ok = col_ok[:c]
    out_x, out_h = {}, {}
    for i, ((name, xl), (_, hl)) in enumerate(zip(xs, hs)):
        D = xl[0].numel()
        kind = wire_mod.resolve_kind(D, policy)
        quant = _leaf_quant(kind, seed, i, D)
        down_quant = _down_quant(kind, seed, i, D) if wdown else None
        if impl == "ws":
            out_x[name], out_h[name] = _ws_cyclic_leaf(
                xl, hl, slot, client_of, col_ok, c, s, scale, down,
                survivor, quant, down_quant, robust)
        else:
            out_x[name], out_h[name] = _dense_cyclic_leaf(
                xl, hl, slot, c, s, scale, down, sanitize=faulted,
                survivor=survivor, quant=quant, down_quant=down_quant,
                robust=robust)
    if isinstance(x, torch.Tensor):
        return out_x[None], out_h[None]
    return out_x, out_h
