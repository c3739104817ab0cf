"""The client workspace and the unmeshed comm step (``repro.dist.comm_ws``).

The state of every client lives in one ``(n, d_total)`` f32 workspace per
quantity (x and h), each row one client's parameters flattened leaf by
leaf in the reference's leaf order (``WorkspaceSpec``).  Where the
reference packs its per-leaf state into that layout and unpacks it again
each round (``comm_ws.pack``/``unpack``, two copies of the state), the port
keeps the state in it: a leaf is a view into a row, the local step updates
a client's row in place and the comm step updates both workspaces in
place.  The numbers are those of the reference's kernel path
(``comm_ws._pallas_comm`` with ``survivor=False``, no wire, no robust
combine); only the copies are gone.

The cyclic band ``(-s k_leaf) mod c`` restarts at every leaf, so the leaf
order and the stacked ``(n_layers, ...)`` block leaves decide which client
owns which coordinate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import compress, uplink


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


def cyclic_comm(xw: torch.Tensor, hw: torch.Tensor, slot: torch.Tensor,
                band: torch.Tensor, c: int, s: int, scale: float,
                down: Optional[torch.Tensor] = None) -> torch.Tensor:
    """UpCom + control-variate update + DownCom of the cyclic template, in
    place on the workspaces; returns the rebuilt server model ``x_bar``.

    ``slot`` ``(n,)`` int32 is each client's template column (-1 when idle),
    ``down`` ``(n,)`` int32 the DownCom rows (``None``: every row)."""
    x_bar = uplink.masked_sum(xw, slot, band, c, s)
    uplink.h_update(xw, hw, x_bar, slot, band, c, s, scale, down=down)
    return x_bar
