"""The comm step's kernels over the ``(n, d)`` f32 client workspace.

``masked_sum`` replaces the Pallas ``repro.kernels.uplink.masked_sum``
(``_masked_sum_kernel``, uplink.py:55): the owner-masked client-axis sum
with the exact ``1/s`` rebuild.  It must read the owned entries of x (s of
them per coordinate), the band and write x_bar: 4 B x (s + 2) per
coordinate on one H100 at 3.35 TB/s.  With ``counts=True`` it replaces
``_masked_sum_counts_kernel`` (uplink.py:65), the survivor UpCom: the raw
owner sum and the owner count, 4 B per owned entry + 12 B per coordinate.
Both also take the bf16 and f16 lanes of the narrow float wire (2 B per
owned entry), converted to f32 exactly and summed in f32.  The kernel
gives a warp 512 columns (a grid of the blocks the card holds at once
strides over them) and each lane four quads of 4 columns, 128 apart, so
that every warp-wide load and store is one contiguous span; it reads the
band as 16-byte loads, loads 4 rows' quads (16 or 8 bytes each) together
before their ownership is known, for the rows whose slot lies in
``[0, m)`` only, tests ownership by a compare and writes 16-byte stores.
Rows off the 16-byte grid, bands outside ``[0, m)`` and the ragged tail
take a scalar path with the same arithmetic.

``masked_sum_dequant`` replaces ``repro.kernels.uplink.masked_sum_dequant``
(``_masked_sum_dequant_kernel``, uplink.py:80, and with ``counts=True``
``_masked_sum_dequant_counts_kernel``, uplink.py:94): the same UpComs over
the int wire, int8 codes times their row's per-chunk f32 scale.  It reads
1 B per owned code, the band and writes the outputs: (s + 8) B per
coordinate, (s + 12) B with the counts.  The kernel takes 16 coordinates
per thread as four quads that a warp reads and writes in contiguous
spans, one scale per quad and row, and a leaf cursor instead of a search
per coordinate; the wrapper takes the leaf starts as host integers, so
it never waits for the card.

``robust_sum`` replaces ``repro.kernels.uplink.robust_sum``
(``_robust_sum_kernel``, uplink.py:106): the per-coordinate trimmed mean or
median of the owned values.  It moves the bytes of the counts kernel, in
the same layout; its order statistics stay in registers, S per column, so
a lane takes 16 columns for s <= 4, 8 for s <= 8 and 4 for s <= 16.  For
``s > 16`` a second kernel (``robust_sum_large_s``) also reads each owned
entry once, in one walk over the rows with a column per thread, and
appends it to its column's list in shared memory (up to ``min(s + 8,
n)`` values per column, rank-major so a warp's accesses hit distinct
banks; 256 columns per block, 128 where the lists need it); each thread
then sorts its column, through a bitonic network in registers for s up
to 64, and combines.  Past what 128 columns' lists fit in one block's
shared memory the lists live in a global scratch buffer that the wrapper
allocates.

``h_update`` replaces ``repro.kernels.uplink.h_update`` (``_h_update_kernel``,
uplink.py:153): ``h += scale (x_bar - x)`` on owned coordinates and the
DownCom ``x = x_bar`` on the ``down`` rows, in place.  It must read x and h
and write h on owned entries, read x_bar and the band, and write the
``down`` rows of x: 4 B x (3 s + 2 + n_down) per coordinate.  With
``covered`` it replaces ``_h_update_covered_kernel`` (uplink.py:167): both
updates gated by a ``(d,)`` bool, 1 B per coordinate more, and nothing
touched where the gate is off.  A thread takes 4 coordinates, reads
x_bar, the band and the gate once and then each row that owns or
downloads any of the 4.  Up to 4096 rows the kernel stages slot and down
in shared memory and walks every row per quad; above
(``h_update_large_n``, ``h_update_covered_large_n``) one block first
lists, on the stream, the rows whose slot lies in ``[0, m)`` or that
download (into an ``n + 1`` int scratch buffer the wrapper allocates;
the length stays on the card), and a persistent grid then walks (16
listed rows) x (1024 columns) tiles, a warp's lanes on consecutive
columns, so only those rows are visited, a partly covered or ragged row
still moves whole sectors, and a small ``d`` still fills the card.
The C entries pick the kernel by size (``kMaxRobustS``, ``kHMaxRows`` in
the source) and report which one they launched, which names the count.

All evaluate ownership in the kernel from the per-coordinate ``band``
table and the per-client ``slot`` vector (``compress.owned_from_band``);
no ``(n, d)`` mask exists.  The f32 workspace of ``masked_sum``,
``robust_sum`` and ``h_update`` may be the first ``d`` columns of a wider
one (``ws[:, :d]``: rows contiguous, a row pitch ``stride(0) >= d``), as
the comm step passes it when tall-and-thin leaves lie after those columns;
``h`` then has the same pitch.  A CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import ctypes

import torch

from repro_torch.kernels import _build, compress, ref

# lane types of the mean UpComs and the kernels' lane codes
LANES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_LANE_NAME = {torch.float32: "", torch.float16: "_f16",
              torch.bfloat16: "_bf16"}


def _check(x: torch.Tensor, m: int, s: int,
           lanes: Tuple[torch.dtype, ...] = (torch.float32,),
           pitched: bool = True, **others: torch.Tensor) -> None:
    """Checks shared by the wrappers: ``1 <= s <= m``; the workspace ``x``
    is ``(n, d)`` of a type in ``lanes`` with contiguous rows (a row pitch
    ``stride(0) >= d`` when ``pitched``, else contiguous); ``h`` is ``(n,
    d)`` f32 with x's strides, ``x_bar`` ``(d,)`` f32, ``band`` ``(d,)``
    int32, ``covered`` ``(d,)`` bool, ``slot`` and ``down`` ``(n,)`` int32,
    contiguous, all on the workspace's device."""
    if not 1 <= s <= m:
        raise ValueError(f"need 1 <= s <= m, got s={s} m={m}")
    if x.dim() != 2 or x.dtype not in lanes or not (
            x.is_contiguous() or (pitched and x.stride(1) == 1
                                  and x.stride(0) >= x.shape[1])):
        raise ValueError(f"workspace must be a contiguous (n, d) tensor of "
                         f"{lanes}, got {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    want = {"h": ((n, d), torch.float32), "x_bar": ((d,), torch.float32),
            "band": ((d,), torch.int32), "slot": ((n,), torch.int32),
            "down": ((n,), torch.int32), "covered": ((d,), torch.bool)}
    for name, t in others.items():
        shape, dtype = want[name]
        layout_ok = (t.stride() == x.stride() if name == "h"
                     else t.is_contiguous())
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not layout_ok or t.device != x.device):
            raise ValueError(f"{name}: want a contiguous {dtype} tensor of "
                             f"shape {shape} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def masked_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int, counts: bool = False):
    """``x_bar[k] = sum_{i owns k} x[i, k] / s`` over the ``(n, d)``
    workspace of f32, f16 or bf16 lanes (summed in f32); ``slot`` ``(n,)``
    int32 (outside ``[0, m)`` owns nothing), ``band`` ``(d,)`` int32.
    ``counts=True`` returns ``(num, cnt)`` instead: the undivided owner sum
    and the f32 owner count, from which the survivor path rebuilds
    ``num / max(cnt, 1)``."""
    _check(x, m, s, lanes=tuple(LANES), slot=slot, band=band)
    if x.device.type == "cpu":
        if counts:
            return ref.masked_sum_counts(x, slot, band, m, s)
        return ref.masked_sum(x, slot, band, m, s)
    n, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    lib = _build.load()
    lane = LANES[x.dtype]
    name = ("masked_sum_counts" if counts else "masked_sum") + \
        _LANE_NAME[x.dtype]
    if counts:
        cnt = torch.empty(d, dtype=torch.float32, device=x.device)
        rc = lib.tamuna_masked_sum_counts(
            x.data_ptr(), lane, slot.data_ptr(), band.data_ptr(),
            out.data_ptr(), cnt.data_ptr(), n, d, x.stride(0), m, s,
            _build.stream_of(x))
        _build.check_launch(name, rc)
        return out, cnt
    rc = lib.tamuna_masked_sum(
        x.data_ptr(), lane, slot.data_ptr(), band.data_ptr(), out.data_ptr(),
        n, d, x.stride(0), m, s, _build.stream_of(x))
    _build.check_launch(name, rc)
    return out


def _leaf_starts(leaf_lo) -> Tuple[int, ...]:
    """A kind group's leaf starts as host integers, from a sequence of
    ints or a CPU tensor.  A tensor elsewhere is refused: reading it back
    would make the caller wait for the card."""
    if isinstance(leaf_lo, torch.Tensor) and leaf_lo.device.type != "cpu":
        raise ValueError(f"leaf_lo: want host integers, got a tensor on "
                         f"{leaf_lo.device}")
    return tuple(int(v) for v in leaf_lo)


def masked_sum_dequant(codes: torch.Tensor, scales: torch.Tensor,
                       leaf_lo: Sequence[int], slot: torch.Tensor,
                       band: torch.Tensor, m: int, s: int,
                       counts: bool = False):
    """``masked_sum`` over int wire lanes: ``codes`` ``(n, d)`` int8 (int4
    codes fit), ``scales`` ``(n, nchunk)`` f32 per-chunk scales, and
    ``leaf_lo`` the kind group's ``L + 1`` leaf starts in its ``d``
    columns (the first 0, the last ``d``), as host integers (a sequence or
    a CPU tensor), from which each column's scale column follows
    (``compress.chunk_cols``).  Each owned code times its scale is summed
    in f32; ``counts=True`` returns ``(num, cnt)`` as ``masked_sum``
    does.  On the card the leaf tables are copied once per group
    (``_build.device_table``) and nothing is read back."""
    _check(codes, m, s, lanes=(torch.int8,), pitched=False, slot=slot,
           band=band)
    n, d = codes.shape
    lo = _leaf_starts(leaf_lo)
    coff = tuple(compress.chunk_offsets(lo))
    nc = coff[-1]
    if (scales.shape != (n, nc) or scales.dtype != torch.float32
            or not scales.is_contiguous() or scales.device != codes.device
            or len(lo) < 2 or lo[0] != 0 or lo[-1] != d
            or any(b < a for a, b in zip(lo, lo[1:]))):
        raise ValueError(
            f"want scales ({n}, {nc}) f32 on {codes.device} and leaf_lo "
            f"rising from 0 to {d}, got scales {tuple(scales.shape)} "
            f"{scales.dtype} on {scales.device}, leaf_lo {list(lo)}")
    if codes.device.type == "cpu":
        return ref.masked_sum_dequant(codes, scales,
                                      torch.tensor(lo, dtype=torch.int64),
                                      slot, band, m, s, counts=counts)
    out = torch.empty(d, dtype=torch.float32, device=codes.device)
    cnt = (torch.empty(d, dtype=torch.float32, device=codes.device)
           if counts else None)
    rc = _build.load().tamuna_masked_sum_dequant(
        codes.data_ptr(), scales.data_ptr(), nc,
        _build.device_table(lo, codes.device).data_ptr(),
        _build.device_table(coff, codes.device).data_ptr(), len(lo) - 1,
        slot.data_ptr(), band.data_ptr(), out.data_ptr(),
        None if cnt is None else cnt.data_ptr(), n, d, m, s, int(counts),
        _build.stream_of(codes))
    _build.check_launch(
        "masked_sum_dequant_counts" if counts else "masked_sum_dequant", rc)
    return (out, cnt) if counts else out


def robust_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int, *, kind: str,
               k: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate trimmed mean (``kind="trimmed"``, ``k`` values off
    each side, ``0 <= 2k < s``) or median (``kind="median"``) of the owned
    values; returns ``(x_bar, cnt)``: the combined value (0 where no row
    owns the coordinate; not to be divided) and the f32 owner count."""
    if kind not in ("trimmed", "median"):
        raise ValueError(f"robust_sum kind {kind!r}")
    if kind == "trimmed" and not 0 <= 2 * int(k) < s:
        raise ValueError(f"robust_sum needs 0 <= 2k < s (k={k}, s={s})")
    _check(x, m, s, slot=slot, band=band)
    if x.device.type == "cpu":
        return ref.robust_sum(x, slot, band, m, s, kind, int(k))
    n, d = x.shape
    bar = torch.empty(d, dtype=torch.float32, device=x.device)
    cnt = torch.empty(d, dtype=torch.float32, device=x.device)
    lib = _build.load()
    # the lists of a very large s live in global memory (0 bytes otherwise)
    nbytes = lib.tamuna_robust_sum_scratch(n, d, s)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
               if nbytes else None)
    variant = ctypes.c_int(-1)
    rc = lib.tamuna_robust_sum(
        x.data_ptr(), slot.data_ptr(), band.data_ptr(), bar.data_ptr(),
        cnt.data_ptr(), n, d, x.stride(0), m, s, int(k),
        int(kind == "median"), None if scratch is None else scratch.data_ptr(),
        nbytes, _build.stream_of(x), ctypes.byref(variant))
    _build.check_variant_launch(("robust_sum", "robust_sum_large_s"), rc,
                                variant)
    return bar, cnt


def h_update(x: torch.Tensor, h: torch.Tensor, x_bar: torch.Tensor,
             slot: torch.Tensor, band: torch.Tensor, m: int, s: int,
             scale: float, down: Optional[torch.Tensor] = None,
             covered: Optional[torch.Tensor] = None) -> None:
    """In place: ``h += scale (x_bar - x)`` on owned coordinates and the
    DownCom ``x = x_bar`` on the ``down`` rows (``(n,)`` int32 0/1; every
    row when ``None``).  Rows outside ``down`` keep their ``x`` bit-exactly
    and unowned coordinates keep their ``h`` bit-exactly.  ``covered``
    (``(d,)`` bool, the survivor path) gates both per coordinate:
    uncovered coordinates keep h and x bit-exactly."""
    _check(x, m, s, h=h, x_bar=x_bar, slot=slot, band=band,
           **({} if down is None else {"down": down}),
           **({} if covered is None else {"covered": covered}))
    if x.device.type == "cpu":
        ref.h_update(x, h, x_bar, slot, band, m, s, scale, down, covered)
        return
    n, d = x.shape
    if down is None:
        down = torch.ones(n, dtype=torch.int32, device=x.device)
    lib = _build.load()
    args = (x.data_ptr(), h.data_ptr(), x_bar.data_ptr(), slot.data_ptr(),
            down.data_ptr(), band.data_ptr())
    # past the rows it stages, the kernel lists the rows it touches
    nrows = lib.tamuna_h_update_scratch(n)
    rows = (torch.empty(nrows, dtype=torch.int32, device=x.device)
            if nrows else None)
    variant = ctypes.c_int(-1)
    tail = (n, d, x.stride(0), m, s, float(scale),
            None if rows is None else rows.data_ptr(), _build.stream_of(x),
            ctypes.byref(variant))
    if covered is None:
        name = "h_update"
        rc = lib.tamuna_h_update(*args, *tail)
    else:
        # a bool tensor is stored one byte per element, 0 or 1: the
        # kernel's uint8 gate
        name = "h_update_covered"
        rc = lib.tamuna_h_update_covered(*args, covered.data_ptr(), *tail)
    _build.check_variant_launch((name, name + "_large_n"), rc, variant)
