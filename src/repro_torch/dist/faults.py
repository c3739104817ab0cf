"""Deterministic fault plans and payload guards (``repro.dist.faults``).

``FaultModel``, ``FaultPlan`` and ``EmpiricalDelays`` are numpy and are
copied from the reference: every draw is a pure function of ``(seed,
round, attempt)`` through ``np.random.SeedSequence`` with the same stream
tags, so a port run and a reference run with the same seed drop, corrupt,
delay and turn Byzantine the same clients.

The device halves work on the ``(n, d_total)`` f32 client workspace in
place, over the listed rows only and in column chunks, so no ``(n, d)``
bool or f32 temporary is made (at full width one costs gigabytes):

``nonfinite_clients``   the payload guard: rows with a nonfinite entry
                        (or one above ``max_abs``);
``corrupt_rows``        what a corrupted uplink looks like: NaN, inf or a
                        ``blowup``-scaled row;
``adversarial_rows``    what a Byzantine uplink looks like: negated,
                        scaled, or the collusive ``inlier`` payload.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.ref import CHUNK  # columns per workspace pass

__all__ = [
    "FaultModel",
    "FaultPlan",
    "EmpiricalDelays",
    "nonfinite_clients",
    "corrupt_rows",
    "adversarial_rows",
    "CORRUPT_MODES",
    "ADVERSARIES",
]

CORRUPT_MODES = ("nan", "inf", "blowup")

# Byzantine behaviours: a persistent set of f_byz * n clients whose uplinks
# arrive finite and plausible-looking every round they participate
ADVERSARIES = ("none", "sign_flip", "scale", "inlier")

# SeedSequence stream tags, the reference's: disjoint from cohort.py's
# (53, 59, 211) so a shared seed never correlates availability with faults
_TAG_DROP = 101
_TAG_CORRUPT = 103
_TAG_DELAY = 107
_TAG_BASE = 109
_TAG_EMPIRICAL = 113
_TAG_BYZ = 127


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Static description of a fleet's failure behaviour.

    ``p_drop``       per-client per-attempt probability that the uplink
                     never lands.
    ``p_corrupt``    per-client per-attempt probability that the payload
                     arrives corrupted (``corrupt_mode``: "nan" | "inf",
                     caught by the nonfinite guard, or "blowup", a finite
                     row scaled by ``blowup``).
    ``delay_*``      straggler model: a persistent per-client lognormal
                     base latency (``straggler_frac`` of the fleet
                     ``straggler_scale`` slower) times a fresh per-attempt
                     lognormal jitter, in simulated seconds.
    ``adversary``    Byzantine behaviour of a persistent ``f_byz``
                     fraction: "sign_flip" negates the payload, "scale"
                     multiplies it by ``byz_scale``, "inlier" sends
                     ``honest_mean - byz_z * honest_std`` per coordinate.
    """

    p_drop: float = 0.0
    p_corrupt: float = 0.0
    corrupt_mode: str = "nan"
    blowup: float = 1e8
    delay_mu: float = 0.0
    delay_sigma: float = 0.2
    straggler_frac: float = 0.0
    straggler_scale: float = 10.0
    adversary: str = "none"
    f_byz: float = 0.0
    byz_scale: float = -10.0
    byz_z: float = 1.5

    def __post_init__(self):
        if not (0.0 <= self.p_drop <= 1.0):
            raise ValueError(f"p_drop={self.p_drop} outside [0, 1]")
        if not (0.0 <= self.p_corrupt <= 1.0):
            raise ValueError(f"p_corrupt={self.p_corrupt} outside [0, 1]")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt_mode {self.corrupt_mode!r}; want one of "
                f"{CORRUPT_MODES}"
            )
        if self.adversary not in ADVERSARIES:
            raise ValueError(
                f"unknown adversary {self.adversary!r}; want one of "
                f"{ADVERSARIES}"
            )
        if not (0.0 <= self.f_byz < 1.0):
            raise ValueError(f"f_byz={self.f_byz} outside [0, 1)")
        if self.f_byz > 0.0 and self.adversary == "none":
            raise ValueError("f_byz > 0 needs an adversary model")

    @property
    def adversarial(self) -> bool:
        """Whether a Byzantine set actually exists under this model."""
        return self.adversary != "none" and self.f_byz > 0.0


class FaultPlan:
    """Replayable per-round fault draws for ``n`` clients.

    Every query is a pure function of ``(seed, round, attempt)``: draws
    are independent of query order, and ``attempt`` indexes quorum
    retries (each retry re-draws drops, corruption and delays)."""

    def __init__(self, seed: int, n: int,
                 model: Optional[FaultModel] = None, **kw):
        if model is not None and kw:
            raise ValueError("pass a FaultModel or kwargs, not both")
        self.seed, self.n = int(seed), int(n)
        self.model = model if model is not None else FaultModel(**kw)
        # persistent per-client straggler identity: a function of the
        # seed alone (round-independent)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, _TAG_BASE])
        )
        base = rng.lognormal(self.model.delay_mu, self.model.delay_sigma,
                             size=self.n)
        base[rng.random(self.n) < self.model.straggler_frac] *= \
            self.model.straggler_scale
        self._base = base

    @classmethod
    def zero(cls, n: int, seed: int = 0) -> "FaultPlan":
        """The zero-fault plan: nothing drops, corrupts, or straggles.
        ``rounds.run_rounds`` under this plan (policy ``wait_all``) runs
        the fault-free round, bitwise."""
        return cls(seed, n, FaultModel())

    @property
    def is_zero(self) -> bool:
        m = self.model
        return (m.p_drop == 0.0 and m.p_corrupt == 0.0
                and m.straggler_frac == 0.0 and not m.adversarial)

    @property
    def byzantine(self) -> np.ndarray:
        """(n,) bool: the persistent Byzantine set, the first
        ``round(f_byz * n)`` clients of a permutation drawn from the seed
        alone."""
        m = self.model
        mask = np.zeros(self.n, bool)
        if not m.adversarial:
            return mask
        k = int(round(m.f_byz * self.n))
        if k == 0:
            return mask
        perm = np.random.default_rng(
            np.random.SeedSequence([self.seed, _TAG_BYZ])
        ).permutation(self.n)
        mask[perm[:k]] = True
        return mask

    def _rng(self, tag: int, rnd: int, attempt: int):
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.seed, tag, int(rnd), int(attempt)]
            )
        )

    def drops(self, rnd: int, attempt: int = 0) -> np.ndarray:
        """(n,) bool: client ``i``'s uplink never lands this attempt."""
        if self.model.p_drop == 0.0:
            return np.zeros(self.n, bool)
        u = self._rng(_TAG_DROP, rnd, attempt).random(self.n)
        return u < self.model.p_drop

    def corrupts(self, rnd: int, attempt: int = 0) -> np.ndarray:
        """(n,) bool: client ``i``'s payload arrives corrupted."""
        if self.model.p_corrupt == 0.0:
            return np.zeros(self.n, bool)
        u = self._rng(_TAG_CORRUPT, rnd, attempt).random(self.n)
        return u < self.model.p_corrupt

    def delays(self, rnd: int, attempt: int = 0) -> np.ndarray:
        """(n,) float64 simulated uplink-arrival delays: the persistent
        per-client base times a fresh per-attempt lognormal jitter."""
        jit = self._rng(_TAG_DELAY, rnd, attempt).lognormal(
            0.0, self.model.delay_sigma, size=self.n
        )
        return self._base * jit

    @property
    def base_delays(self) -> np.ndarray:
        """(n,) persistent per-client base latency (straggler identity)."""
        return self._base.copy()


class EmpiricalDelays:
    """Replayable per-round latency draws resampled from a measured
    per-step latency sample set; ``delays(rnd, attempt)`` is a pure
    function of ``(seed, rnd, attempt)``."""

    def __init__(self, samples, n: int, seed: int = 0):
        samples = np.asarray(samples, np.float64).reshape(-1)
        if samples.size == 0:
            raise ValueError("EmpiricalDelays needs at least one sample")
        if not np.all(np.isfinite(samples)) or np.any(samples < 0):
            raise ValueError("latency samples must be finite and >= 0")
        self.samples = samples
        self.n, self.seed = int(n), int(seed)

    @classmethod
    def from_json(cls, path: str, n: int, seed: int = 0
                  ) -> "EmpiricalDelays":
        """Load a latency export (key ``per_step_latency_s``)."""
        with open(path) as f:
            blob = json.load(f)
        return cls(blob["per_step_latency_s"], n=n, seed=seed)

    def delays(self, rnd: int, attempt: int = 0) -> np.ndarray:
        """(n,) float64 per-step latency draws for the round (bootstrap
        resample of the measured distribution)."""
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [self.seed, _TAG_EMPIRICAL, int(rnd), int(attempt)]
            )
        )
        return self.samples[rng.integers(0, self.samples.size, self.n)]

    def quantile(self, q) -> np.ndarray:
        """Tail summary of the measured distribution (for reporting)."""
        return np.quantile(self.samples, q)


# --------------------------------------------------------------------------
# device halves: payload guard + injection, in place on the workspace
# --------------------------------------------------------------------------


def _rows(mask) -> list:
    return np.flatnonzero(np.asarray(mask, bool)).tolist()


def nonfinite_clients(ws: torch.Tensor, rows: Optional[Sequence[bool]] = None,
                      max_abs: Optional[float] = None) -> np.ndarray:
    """(n,) bool: the ``rows`` (a ``(n,)`` mask; every row when ``None``)
    whose payload fails the guard: a nonfinite entry, or (``max_abs``
    given) a magnitude above it.  Rows outside ``rows`` are False."""
    n, d = ws.shape
    rows = np.ones(n, bool) if rows is None else np.asarray(rows, bool)
    bad = np.zeros(n, bool)
    for i in _rows(rows):
        for a in range(0, d, CHUNK):
            f = ws[i, a:a + CHUNK]
            ok = torch.isfinite(f)
            if max_abs is not None:
                ok &= f.abs() <= max_abs
            if not bool(ok.all()):
                bad[i] = True
                break
    return bad


def corrupt_rows(ws: torch.Tensor, mask, mode: str = "nan",
                 blowup: float = 1e8) -> None:
    """In place: corrupt the ``mask``'ed rows: ``nan``/``inf`` overwrite
    the row, ``blowup`` scales it.  Other rows are not touched."""
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    for i in _rows(mask):
        if mode == "blowup":
            ws[i].mul_(blowup)
        else:
            ws[i].fill_(float("nan") if mode == "nan" else float("inf"))


def adversarial_rows(ws: torch.Tensor, byz, honest, mode: str,
                     byz_scale: float = -10.0, byz_z: float = 1.5) -> None:
    """In place: Byzantine payloads in the ``byz`` rows.  ``sign_flip``
    negates, ``scale`` multiplies by ``byz_scale``; ``inlier`` writes
    ``mean - byz_z * std`` of the ``honest & ~byz`` rows per coordinate
    (population std; 0 when no row is honest).  Other rows are not
    touched."""
    if mode not in ADVERSARIES or mode == "none":
        raise ValueError(f"unknown adversary mode {mode!r}")
    byz = np.asarray(byz, bool)
    bad_rows = _rows(byz)
    if mode == "sign_flip":
        for i in bad_rows:
            ws[i].neg_()
        return
    if mode == "scale":
        for i in bad_rows:
            ws[i].mul_(byz_scale)
        return
    good = _rows(np.asarray(honest, bool) & ~byz)
    cnt = float(max(len(good), 1))
    d = ws.shape[1]
    for a in range(0, d, CHUNK):
        cols = slice(a, min(a + CHUNK, d))
        mu = torch.zeros(cols.stop - a, dtype=torch.float32,
                         device=ws.device)
        for i in good:
            mu = mu + ws[i, cols]
        mu = mu / cnt
        var = torch.zeros_like(mu)
        for i in good:
            var = var + (ws[i, cols] - mu) ** 2
        var = var / cnt
        v = mu - byz_z * torch.sqrt(var)
        for i in bad_rows:
            ws[i, cols] = v
