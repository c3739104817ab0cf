"""The comm step's two kernels over the ``(n, d)`` f32 client workspace.

``masked_sum`` replaces the Pallas ``repro.kernels.uplink.masked_sum``
(``_masked_sum_kernel``, uplink.py:55): the owner-masked client-axis sum
with the exact ``1/s`` rebuild.  It must read the owned entries of x (s of
them per coordinate), the band and write x_bar: 4 B x (s + 2) per
coordinate on one H100 at 3.35 TB/s.

``h_update`` replaces ``repro.kernels.uplink.h_update`` (``_h_update_kernel``,
uplink.py:153): ``h += scale (x_bar - x)`` on owned coordinates and the
DownCom ``x = x_bar`` on the ``down`` rows, in place.  It must read x and h
and write h on owned entries, read x_bar and the band, and write the
``down`` rows of x: 4 B x (3 s + 2 + n_down) per coordinate.

Both evaluate ownership in the kernel from the per-coordinate ``band``
table and the per-client ``slot`` vector (``compress.owned_from_band``);
no ``(n, d)`` mask exists.  A CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def _check(x: torch.Tensor, m: int, s: int, **others: torch.Tensor) -> None:
    """Checks shared by both wrappers: ``1 <= s <= m``; ``h`` is ``(n, d)``
    f32, ``x_bar`` ``(d,)`` f32, ``band`` ``(d,)`` int32, ``slot`` and
    ``down`` ``(n,)`` int32, all contiguous and on the workspace's
    device."""
    if not 1 <= s <= m:
        raise ValueError(f"need 1 <= s <= m, got s={s} m={m}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"workspace must be a contiguous (n, d) f32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    want = {"h": ((n, d), torch.float32), "x_bar": ((d,), torch.float32),
            "band": ((d,), torch.int32), "slot": ((n,), torch.int32),
            "down": ((n,), torch.int32)}
    for name, t in others.items():
        shape, dtype = want[name]
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name}: want a contiguous {dtype} tensor of "
                             f"shape {shape} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def masked_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int) -> torch.Tensor:
    """``x_bar[k] = sum_{i owns k} x[i, k] / s`` over the ``(n, d)`` f32
    workspace; ``slot`` ``(n,)`` int32 (outside ``[0, m)`` owns nothing),
    ``band`` ``(d,)`` int32."""
    _check(x, m, s, slot=slot, band=band)
    if x.device.type == "cpu":
        return ref.masked_sum(x, slot, band, m, s)
    n, d = x.shape
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    rc = _build.load().tamuna_masked_sum(
        x.data_ptr(), slot.data_ptr(), band.data_ptr(), out.data_ptr(),
        n, d, m, s, _build.stream_of(x))
    _build.check_launch("masked_sum", rc)
    return out


def h_update(x: torch.Tensor, h: torch.Tensor, x_bar: torch.Tensor,
             slot: torch.Tensor, band: torch.Tensor, m: int, s: int,
             scale: float, down: Optional[torch.Tensor] = None) -> None:
    """In place: ``h += scale (x_bar - x)`` on owned coordinates and the
    DownCom ``x = x_bar`` on the ``down`` rows (``(n,)`` int32 0/1; every
    row when ``None``).  Rows outside ``down`` keep their ``x`` bit-exactly
    and unowned coordinates keep their ``h`` bit-exactly."""
    _check(x, m, s, h=h, x_bar=x_bar, slot=slot, band=band,
           **({} if down is None else {"down": down}))
    if x.device.type == "cpu":
        ref.h_update(x, h, x_bar, slot, band, m, s, scale, down)
        return
    n, d = x.shape
    if n > 65535:
        raise ValueError(f"h_update takes at most 65535 client rows, got {n}")
    if down is None:
        down = torch.ones(n, dtype=torch.int32, device=x.device)
    rc = _build.load().tamuna_h_update(
        x.data_ptr(), h.data_ptr(), x_bar.data_ptr(), slot.data_ptr(),
        down.data_ptr(), band.data_ptr(), n, d, m, s, float(scale),
        _build.stream_of(x))
    _build.check_launch("h_update", rc)
