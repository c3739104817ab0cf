"""Parameter rules of the paper (copied from ``repro.core.theory``)."""

from __future__ import annotations


def chi_max(n: int, s: int) -> float:
    """Upper bound (5): ``chi <= n(s-1)/(s(n-1)) in (1/2, 1]``."""
    return n * (s - 1) / (s * (n - 1))


def recommended_eta(p: float, n: int, s: int) -> float:
    """Remark 2, eq. (11): ``eta = p * n(s-1)/(s(n-1))`` (largest valid)."""
    return p * chi_max(n, s)
