"""Plain PyTorch versions of the three CUDA kernels of the training round.

They are the kernels' oracles: the wrappers run them for CPU tensors, the
CPU tests hold them against the reference's Pallas kernels in interpret
mode, and ``chip_smoke.py`` holds each kernel against them on the card.
Each repeats its kernel's arithmetic operation for operation (the client
rows are summed in row order, the products are not contracted into FMAs),
so a kernel and its plain version agree bitwise on the same inputs.

Ownership selects and never multiplies: idle rows may hold anything, NaN
included, and never reach an output.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.compress import owned_from_band


def masked_sum(x: torch.Tensor, slot: torch.Tensor, band: torch.Tensor,
               m: int, s: int) -> torch.Tensor:
    """UpCom with the exact rebuild: ``x_bar[k] = sum_{i owns k} x[i, k] / s``
    over the ``(n, d)`` workspace, rows added in order."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        owned = owned_from_band(slot[i], band, m, s)
        acc = acc + torch.where(owned, x[i], 0.0)
    return acc / s


def h_update(x: torch.Tensor, h: torch.Tensor, x_bar: torch.Tensor,
             slot: torch.Tensor, band: torch.Tensor, m: int, s: int,
             scale: float, down: Optional[torch.Tensor] = None) -> None:
    """In place: ``h += scale * (x_bar - x)`` on owned coordinates (h on
    unowned coordinates is not written), then the DownCom ``x = x_bar`` on
    the ``down`` rows (every row when ``None``); other rows of ``x`` are
    not written."""
    for i in range(x.shape[0]):
        owned = owned_from_band(slot[i], band, m, s)
        h[i] = torch.where(owned, h[i] + scale * (x_bar - x[i]), h[i])
    if down is None:
        x.copy_(x_bar.expand_as(x))
    else:
        x[down.bool()] = x_bar


def fused_local_step(x: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     gamma: float) -> torch.Tensor:
    """The TAMUNA local step ``x - gamma * (g - h)`` in f32."""
    return x - gamma * (g - h)
