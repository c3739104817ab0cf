"""The TAMUNA local step ``x <- x - gamma (g - h)`` as one CUDA pass.

Replaces the Pallas ``repro.kernels.local_step.fused_local_step``
(``_local_step_kernel``, local_step.py:26), reached from the local step of
``dist/tamuna_dp.py``.  It reads x, g and h and writes x once: 16 B per
coordinate on one H100 at 3.35 TB/s, bound by bytes.  A CPU tensor runs the
plain version in ``ref.py``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def fused_local_step(x: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     gamma: float,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x - gamma * (g - h)`` in f32 for same-shape contiguous f32
    tensors; written to ``out`` (which may be ``x`` itself: the local step
    updates the client workspace in place) or to a new tensor."""
    for name, t in (("x", x), ("g", g), ("h", h)) + (
            () if out is None else (("out", out),)):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != x.shape or t.device != x.device):
            raise ValueError(
                f"{name}: want a contiguous f32 tensor of shape "
                f"{tuple(x.shape)} on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if x.device.type == "cpu":
        y = ref.fused_local_step(x, g, h, gamma)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    rc = _build.load().tamuna_local_step(
        x.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(), x.numel(),
        float(gamma), _build.stream_of(x))
    _build.check_launch("fused_local_step", rc)
    return out
