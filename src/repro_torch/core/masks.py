"""Template accounting (copied from ``repro.core.masks``)."""

from __future__ import annotations


def column_nnz(d: int, c: int, s: int) -> int:
    """Worst-case uploaded floats per client: ``ceil(s d / c)`` (or 1)."""
    return max(1, -(-s * d // c))
