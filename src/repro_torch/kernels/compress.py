"""The TAMUNA ownership closed form (``repro.kernels.compress``).

``owned_from_band`` is the one ownership predicate of the comm path: the
plain versions in ``ref.py`` evaluate it here, and the CUDA kernels inline
its ``__device__`` twin of the same name in ``csrc/tamuna_kernels.cu``.
Integer ``%`` on torch tensors is the floor modulo of JAX and Python, which
the CUDA twin reproduces for negative operands.
"""

from __future__ import annotations

import torch


def owned_from_band(slot: torch.Tensor, band: torch.Tensor, m: int,
                    s: int) -> torch.Tensor:
    """Active slots in ``[0, m)`` own coordinate ``k`` iff
    ``(slot + band[k]) mod m < s``.  Shapes broadcast."""
    return (slot >= 0) & (slot < m) & (torch.remainder(slot + band, m) < s)


def cyclic_band(k: torch.Tensor, c: int, s: int) -> torch.Tensor:
    """The cyclic template's per-coordinate band: ``(-s k) mod c``."""
    return torch.remainder(-(s * torch.remainder(k, c)), c)
