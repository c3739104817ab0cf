"""Closed-form rates and communication complexities from the paper
(copied from ``repro.core.theory``, which imports nothing of jax but lives
in a package that does).

These formulas give the parameter tuning rules (Theorem 1, Remark 2,
Theorem 3, Corollaries 4-5) and Theorem 1's contraction factor, which
``chip_smoke.py`` prints beside the measured Lyapunov rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "theorem1_rate",
    "chi_max",
    "recommended_eta",
    "recommended_p",
    "recommended_s",
    "iteration_complexity",
    "upcom_complexity",
    "downcom_complexity",
    "totalcom_complexity",
    "gd_totalcom",
    "scaffnew_totalcom",
    "scaffold_totalcom",
]


def chi_max(n: int, s: int) -> float:
    """Upper bound (5): ``chi <= n(s-1)/(s(n-1)) in (1/2, 1]``."""
    return n * (s - 1) / (s * (n - 1))


def recommended_eta(p: float, n: int, s: int) -> float:
    """Remark 2, eq. (11): ``eta = p * n(s-1)/(s(n-1))`` (largest valid)."""
    return p * chi_max(n, s)


def theorem1_rate(
    gamma: float, mu: float, L: float, p: float, chi: float, n: int, s: int
) -> float:
    """Contraction factor ``tau`` of Theorem 1, eq. (10) (per local step)."""
    return max(
        (1.0 - gamma * mu) ** 2,
        (gamma * L - 1.0) ** 2,
        1.0 - p * p * chi * (s - 1) / (n - 1),
    )


def recommended_p(n: int, s: int, kappa: float) -> float:
    """Eq. (12): ``p = min(sqrt(n/(s kappa)), 1)``."""
    return min(math.sqrt(n / (s * kappa)), 1.0)


def recommended_s(c: int, d: int, alpha: float) -> int:
    """Eq. (14): ``s = max(2, floor(c/d), floor(alpha c))``, capped at c."""
    return min(c, max(2, c // d, int(alpha * c)))


def iteration_complexity(kappa: float, n: int, s: int, p: float) -> float:
    """O(kappa + n/(s p^2)) local steps to eps-accuracy (log factor dropped)."""
    return kappa + n / (s * p * p)


def upcom_complexity(
    kappa: float, n: int, c: int, s: int, d: int, p: float
) -> float:
    """UpCom floats per client: ``p (sd/c + 1)(kappa + n/(s p^2))``."""
    return p * (s * d / c + 1.0) * iteration_complexity(kappa, n, s, p)


def downcom_complexity(
    kappa: float, n: int, c: int, s: int, d: int, p: float
) -> float:
    return p * d * iteration_complexity(kappa, n, s, p)


def totalcom_complexity(
    kappa: float, n: int, c: int, s: int, d: int, p: float, alpha: float
) -> float:
    """Eq. (2): TotalCom = UpCom + alpha * DownCom."""
    return upcom_complexity(kappa, n, c, s, d, p) + alpha * downcom_complexity(
        kappa, n, c, s, d, p
    )


def gd_totalcom(kappa: float, d: int, alpha: float) -> float:
    return (1.0 + alpha) * d * kappa


def scaffnew_totalcom(kappa: float, d: int, alpha: float) -> float:
    return (1.0 + alpha) * d * math.sqrt(kappa)


def scaffold_totalcom(
    kappa: float, d: int, n: int, c: int, alpha: float
) -> float:
    return (1.0 + alpha) * d * (kappa + n / c)


@dataclass(frozen=True)
class TunedParams:
    """Theorem-3 tuned hyperparameters for a given problem."""

    gamma: float
    p: float
    s: int
    chi: float
    eta: float

    @staticmethod
    def for_problem(
        mu: float, L: float, n: int, c: int, d: int, alpha: float
    ) -> "TunedParams":
        kappa = L / mu
        s = recommended_s(c, d, alpha)
        p = recommended_p(n, s, kappa)
        gamma = 2.0 / (L + mu)
        chi = chi_max(n, s)
        eta = p * chi
        return TunedParams(gamma=gamma, p=p, s=s, chi=chi, eta=eta)
