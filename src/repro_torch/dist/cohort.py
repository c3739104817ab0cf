"""Host-side per-round cohort plans and client availability models
(``repro.dist.cohort``, numpy, copied so the port imports no reference).

A :class:`CohortPlan` picks each round's cohort by Gumbel-top-``c`` over
client log-weights, optionally gated by an availability model (Bernoulli
or Markov up/down streams) and by quarantine windows.  Every draw is keyed
by ``np.random.SeedSequence`` with the reference's tags, so a plan with
the same seed gives the same cohorts as the reference's, round by round
and attempt by attempt.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = [
    "BernoulliAvailability",
    "MarkovAvailability",
    "CohortPlan",
]

# weight floor for unavailable clients: small enough that an unavailable
# client is only ever drafted when fewer than c clients are up, large
# enough that the draft among unavailable clients is still a (seeded)
# random choice rather than an argsort tie-break
_DOWN_LOG_WEIGHT = -80.0


@dataclasses.dataclass(frozen=True)
class BernoulliAvailability:
    """Independent per-round availability: client ``i`` is up with
    probability ``p_up[i]`` each round.  ``states(r)`` is a pure function
    of ``(seed, r)``."""

    p_up: np.ndarray  # (n,) in [0, 1]
    seed: int = 0

    def states(self, rnd: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 53, int(rnd)])
        )
        return rng.random(len(self.p_up)) < self.p_up


class MarkovAvailability:
    """Two-state up/down chain per client: ``P(up->down) = p_fail``,
    ``P(down->up) = p_recover``.  ``states(r)`` advances the chain lazily
    from round 0 and caches every visited round, so access is random but
    the stream is the one trajectory of ``seed``."""

    def __init__(self, p_fail, p_recover, n: Optional[int] = None,
                 seed: int = 0):
        p_fail = np.asarray(p_fail, np.float64)
        p_recover = np.asarray(p_recover, np.float64)
        if p_fail.ndim == 0:
            if n is None:
                raise ValueError("scalar rates need an explicit n")
            p_fail = np.full(n, float(p_fail))
        if p_recover.ndim == 0:
            p_recover = np.full(len(p_fail), float(p_recover))
        self.p_fail, self.p_recover = p_fail, p_recover
        self.n = len(p_fail)
        self.seed = seed
        self._states: Dict[int, np.ndarray] = {0: np.ones(self.n, bool)}
        self._frontier = 0

    def states(self, rnd: int) -> np.ndarray:
        rnd = int(rnd)
        while self._frontier < rnd:
            r = self._frontier
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 59, r])
            )
            up = self._states[r]
            u = rng.random(self.n)
            nxt = np.where(up, u >= self.p_fail, u < self.p_recover)
            self._states[r + 1] = nxt
            self._frontier = r + 1
        return self._states[rnd]


class CohortPlan:
    """Replayable per-round cohort plan: Gumbel-top-``c`` over client
    log-weights, availability- and quarantine-gated.  ``cohort(r,
    attempt)`` returns the round's sorted ``(c,)`` client ids,
    ``member_mask(r, attempt)`` its ``(n,)`` bool membership."""

    def __init__(self, seed: int, n: int, c: int, *,
                 availability=None, weights=None):
        if not (2 <= c <= n):
            raise ValueError(f"need 2 <= c <= n, got c={c} n={n}")
        self.seed, self.n, self.c = int(seed), int(n), int(c)
        self.availability = availability
        logw = np.zeros(n) if weights is None else np.log(
            np.asarray(weights, np.float64)
        )
        self._logw = logw
        # non-uniform selection without 1/(n p_i) reweighting biases the
        # aggregate; run_rounds reads this flag to warn
        self.weighted = weights is not None
        self._cache: Dict[tuple, np.ndarray] = {}
        # (ids, first, last) quarantine windows: payload-guard feedback
        self._quarantine: list = []

    def cohort(self, rnd: int, attempt: int = 0) -> np.ndarray:
        """The sorted cohort of round ``rnd``; ``attempt`` indexes quorum
        retries, each a fresh stream (attempt 0 keys as a plan without
        retries)."""
        rnd, attempt = int(rnd), int(attempt)
        key = (rnd, attempt)
        got = self._cache.get(key)
        if got is not None:
            return got
        g = self._gumbel(rnd, attempt)
        top = np.argpartition(-g, self.c - 1)[:self.c]
        out = np.sort(top).astype(np.int32)
        self._cache[key] = out
        return out

    def _gumbel(self, rnd: int, attempt: int) -> np.ndarray:
        """The round's availability/quarantine-gated Gumbel scores."""
        words = ([self.seed, 211, rnd] if attempt == 0
                 else [self.seed, 211, rnd, attempt])
        rng = np.random.default_rng(np.random.SeedSequence(words))
        g = rng.gumbel(size=self.n) + self._logw
        if self.availability is not None:
            g = np.where(self.availability.states(rnd), g,
                         g + _DOWN_LOG_WEIGHT)
        for ids, first, last in self._quarantine:
            if first <= rnd <= last:
                g[ids] = g[ids] + _DOWN_LOG_WEIGHT
        return g

    def member_mask(self, rnd: int, attempt: int = 0) -> np.ndarray:
        mask = np.zeros(self.n, bool)
        mask[self.cohort(rnd, attempt)] = True
        return mask

    def cohort_excluding(self, rnd: int, busy, attempt: int = 0
                         ) -> np.ndarray:
        """The round's cohort with the ``busy`` clients (an ``(n,)`` bool
        mask) barred outright: the pipelined driver keeps rounds in
        flight, and a client mid-round cannot join a new cohort.  The
        Gumbel stream is ``cohort``'s, with a hard ``-inf`` on the busy
        clients (the availability gate's floor is soft); with no busy
        client it is ``cohort``.  Raises when fewer than ``c`` clients are
        free.  Not cached: the busy set is a function of the schedule."""
        busy = np.asarray(busy, bool)
        if busy.shape != (self.n,):
            raise ValueError(f"busy mask shape {busy.shape} != ({self.n},)")
        if not busy.any():
            return self.cohort(rnd, attempt)
        if int((~busy).sum()) < self.c:
            raise ValueError(
                f"only {int((~busy).sum())} free clients for c={self.c} "
                f"at round {rnd}: staleness too deep for this fleet "
                f"(need c * (tau + 1) <= n)"
            )
        g = self._gumbel(int(rnd), int(attempt))
        g = np.where(busy, -np.inf, g)
        top = np.argpartition(-g, self.c - 1)[:self.c]
        return np.sort(top).astype(np.int32)

    def quarantine(self, clients, first_round: int,
                   last_round: int) -> None:
        """Penalize ``clients`` by the unavailability weight floor for
        rounds ``[first_round, last_round]`` (inclusive): they are drafted
        only when fewer than ``c`` healthy clients remain.  Cached draws
        inside the window are purged."""
        ids = np.asarray(clients, np.int64).reshape(-1)
        if ids.size == 0:
            return
        first_round, last_round = int(first_round), int(last_round)
        self._quarantine.append((ids, first_round, last_round))
        for k in [k for k in self._cache
                  if first_round <= k[0] <= last_round]:
            del self._cache[k]
