"""The baselines the paper compares TAMUNA against (the port of
``repro.core.baselines``; Tables 1-2, Figs. 2-3), in float64 on the
problem's device:

  * GD                  distributed gradient descent
  * FedAvg / LocalSGD   local training, no variance reduction
  * Scaffold            local training + control variates (option II)
  * Scaffnew            accelerated local training (ProxSkip)
  * CompressedScaffnew  Scaffnew + the permutation compressor (c = n)
  * DIANA               compressed gradient differences, rand-k
  * EF21                biased compression with error feedback, top-k
  * 5GCS                Point-SAGA over cohorts, inexact prox by local GD

Every ``run_*`` returns ``tamuna.run``'s trace dict (``algo``,
``rounds``, ``suboptimality``, ``up_floats``, ``down_floats``, ``state``,
and ``seconds``), so the traces overlay on one TotalCom axis: TotalCom =
``up_floats + alpha * down_floats`` (paper Section 1.2).

The draws are explicit: a ``run_*`` takes its schedule (``cohorts``,
``coins``, ``perms``, ``indices``: a function of the round or a sequence
indexed by it) and draws a missing one from the port's numpy streams
keyed by ``(seed, fold, round)`` (``compression.split_cohort``,
``masks.sample_permutation``, ``compression.rand_k_indices`` and
``theta_coin`` here).  The reference draws them from jax keys; parity
tests inject its draws.  A division by a constant divides once
(``ref._div``), on the CPU and on the card alike.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import compression, masks
from repro_torch.core.problems import F64, FiniteSumProblem
from repro_torch.kernels.ref import _div

__all__ = [
    "run_gd",
    "run_fedavg",
    "run_scaffold",
    "run_scaffnew",
    "run_compressed_scaffnew",
    "run_diana",
    "run_ef21",
    "run_5gcs",
    "theta_coin",
]

# stream tag of Scaffnew's communication coin: SeedSequence([seed,
# THETA_FOLD, t])
THETA_FOLD = 0x7E7A


def theta_coin(seed: int, t: int, p: float) -> bool:
    """Iteration ``t``'s communication coin, true with probability ``p``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, THETA_FOLD,
                                                        t]))
    return bool(rng.random() < p)


def _schedule(given, default: Callable[[int], object]) -> Callable:
    """A round-indexed draw: ``given`` (a function of the round or a
    sequence indexed by it), else ``default``."""
    if given is None:
        return default
    if callable(given):
        return given
    return lambda r: given[r]


def _index(prob: FiniteSumProblem, idx) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                           device=prob.device)


def _zeros(prob: FiniteSumProblem, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=F64, device=prob.device)


def _trace_loop(prob: FiniteSumProblem, num_rounds: int, step, state: dict,
                up, down, algo: str, record_every: int = 1,
                x_of: Callable[[dict], torch.Tensor] = lambda s: s["x"]
                ) -> dict:
    """Run ``num_rounds`` rounds of ``step(state, r)``; record the
    suboptimality of ``x_of(state)`` and the cumulative floats after round
    ``r`` for ``r % record_every == 0`` and after the last round.  ``up``
    and ``down`` are the floats per round, or functions of the state that
    give the cumulative count."""
    rounds, subopt, ups, downs, secs = [], [], [], [], []
    t0 = time.perf_counter()
    for r in range(num_rounds):
        state = step(state, r)
        if r % record_every == 0 or r == num_rounds - 1:
            rounds.append(r + 1)
            subopt.append(float(prob.suboptimality(x_of(state))))
            ups.append(up(state) if callable(up) else (r + 1) * up)
            downs.append(down(state) if callable(down) else (r + 1) * down)
            secs.append(time.perf_counter() - t0)
    return dict(algo=algo, rounds=np.array(rounds),
                suboptimality=np.array(subopt), up_floats=np.array(ups),
                down_floats=np.array(downs), seconds=np.array(secs),
                state=state)


# --------------------------------------------------------------------------
# GD
# --------------------------------------------------------------------------
def run_gd(prob: FiniteSumProblem, gamma: float, num_rounds: int,
           seed: int = 0, record_every: int = 1) -> dict:
    del seed  # no draws

    def step(state, r):
        return {"x": state["x"] - gamma * prob.grad(state["x"])}

    return _trace_loop(prob, num_rounds, step, {"x": _zeros(prob, prob.d)},
                       prob.d, prob.d, "gd", record_every)


# --------------------------------------------------------------------------
# FedAvg / LocalSGD (local training, biased fixed point: client drift)
# --------------------------------------------------------------------------
def run_fedavg(prob: FiniteSumProblem, gamma: float, local_steps: int,
               c: Optional[int] = None, num_rounds: int = 100,
               seed: int = 0, record_every: int = 1,
               cohorts=None) -> dict:
    c = c or prob.n
    cohort_of = _schedule(
        cohorts, lambda r: compression.split_cohort(seed, r, prob.n, c)[0])

    def step(state, r):
        data = prob.cohort_data(_index(prob, cohort_of(r)))
        X = state["x"].expand(c, prob.d)
        for _ in range(local_steps):
            X = X - gamma * prob.grads(X, data)
        return {"x": X.mean(dim=0)}

    return _trace_loop(prob, num_rounds, step, {"x": _zeros(prob, prob.d)},
                       prob.d, prob.d, "fedavg", record_every)


# --------------------------------------------------------------------------
# Scaffold (option II control variates)
# --------------------------------------------------------------------------
def run_scaffold(prob: FiniteSumProblem, gamma: float, local_steps: int,
                 c: Optional[int] = None, global_lr: float = 1.0,
                 num_rounds: int = 100, seed: int = 0,
                 record_every: int = 1, cohorts=None) -> dict:
    n, d = prob.n, prob.d
    c = c or n
    cohort_of = _schedule(
        cohorts, lambda r: compression.split_cohort(seed, r, n, c)[0])

    def step(state, r):
        x, ci, cg = state["x"], state["ci"], state["cg"]
        cohort = _index(prob, cohort_of(r))
        data = prob.cohort_data(cohort)
        ci_cohort = ci[cohort]
        X = x.expand(c, d)
        for _ in range(local_steps):
            X = X - gamma * (prob.grads(X, data) - ci_cohort + cg)
        # option II: ci+ = ci - cg + (x - y_i) / (K gamma)
        ci_new = ci_cohort - cg + _div(x[None, :] - X, local_steps * gamma)
        dci = ci_new - ci_cohort
        ci[cohort] = ci_new
        cg = cg + _div(dci.sum(dim=0), n)
        x = x + global_lr * (X.mean(dim=0) - x)
        return {"x": x, "ci": ci, "cg": cg}

    state = {"x": _zeros(prob, d), "ci": _zeros(prob, n, d),
             "cg": _zeros(prob, d)}
    # uplink: y_i and the ci delta (2d per client, as in the Scaffold paper)
    return _trace_loop(prob, num_rounds, step, state, 2 * d, 2 * d,
                       "scaffold", record_every)


# --------------------------------------------------------------------------
# Scaffnew / ProxSkip (full participation; communication with prob. p)
# --------------------------------------------------------------------------
def run_scaffnew(prob: FiniteSumProblem, gamma: float, p: float,
                 num_iters: int = 1000, seed: int = 0,
                 record_every: int = 1, coins=None) -> dict:
    """Single-loop Scaffnew; a "round" is one iteration, and the floats
    count on communication iterations only.  ``coins(t)`` is iteration
    ``t``'s communication coin."""
    n, d = prob.n, prob.d
    coin = _schedule(coins, lambda t: theta_coin(seed, t, p))
    data = prob.cohort_data(None)

    def step(state, t):
        X, h = state["X"], state["h"]
        Xhat = X - gamma * prob.grads(X, data) + gamma * h
        if not coin(t):
            return {**state, "X": Xhat}
        xbar = Xhat.mean(dim=0)
        return {"X": xbar.expand(n, d),
                "h": h + (p / gamma) * (xbar[None, :] - Xhat),
                "up": state["up"] + d, "x": xbar}

    state = {"X": _zeros(prob, n, d), "h": _zeros(prob, n, d), "up": 0,
             "x": _zeros(prob, d)}
    up = lambda s: s["up"]  # noqa: E731
    return _trace_loop(prob, num_iters, step, state, up, up, "scaffnew",
                       record_every)


# --------------------------------------------------------------------------
# CompressedScaffnew = Algorithm 2 with full participation (c = n)
# --------------------------------------------------------------------------
def run_compressed_scaffnew(prob: FiniteSumProblem, gamma: float, p: float,
                            s: int, chi: Optional[float] = None,
                            num_iters: int = 1000, seed: int = 0,
                            record_every: int = 1, coins=None,
                            perms=None) -> dict:
    """``coins(t)`` is iteration ``t``'s communication coin, ``perms(t)``
    its ``(n,)`` mask column permutation (drawn on communication
    iterations only)."""
    n, d = prob.n, prob.d
    chi = chi if chi is not None else n * (s - 1) / (s * (n - 1))
    coin = _schedule(coins, lambda t: theta_coin(seed, t, p))
    perm_of = _schedule(perms,
                        lambda t: masks.sample_permutation(seed, t, n))
    data = prob.cohort_data(None)
    upf = masks.column_nnz(d, n, s)

    def step(state, t):
        X, h = state["X"], state["h"]
        Xhat = X - gamma * prob.grads(X, data) + gamma * h
        if not coin(t):
            return {**state, "X": Xhat}
        q = masks.mask_from_permutation(
            torch.as_tensor(np.asarray(perm_of(t)), dtype=torch.int32,
                            device=prob.device), d, n, s)  # (d, n)
        xbar = compression.aggregate_masked(Xhat, q, s)
        hdelta = (p * chi / gamma) * q.T.to(F64) * (xbar[None, :] - Xhat)
        return {"X": xbar.expand(n, d), "h": h + hdelta,
                "up": state["up"] + upf, "down": state["down"] + d,
                "x": xbar}

    state = {"X": _zeros(prob, n, d), "h": _zeros(prob, n, d), "up": 0,
             "down": 0, "x": _zeros(prob, d)}
    return _trace_loop(prob, num_iters, step, state, lambda s_: s_["up"],
                       lambda s_: s_["down"], "compressed_scaffnew",
                       record_every)


# --------------------------------------------------------------------------
# DIANA with rand-k compression of gradient differences
# --------------------------------------------------------------------------
def run_diana(prob: FiniteSumProblem, gamma: float, k: int,
              alpha_lr: Optional[float] = None, num_rounds: int = 500,
              seed: int = 0, record_every: int = 1, indices=None) -> dict:
    """``indices(r)`` is round ``r``'s ``(n, k)`` rand-k coordinates."""
    n, d = prob.n, prob.d
    alpha_lr = alpha_lr if alpha_lr is not None else k / d  # 1/(1+omega)
    idx_of = _schedule(indices, lambda r: compression.rand_k_indices(
        seed, r, d, k, n))

    def step(state, r):
        x, h, hbar = state["x"], state["h"], state["hbar"]
        M = compression.rand_k(prob.grad_all(x) - h, k, idx_of(r))
        Mbar = M.mean(dim=0)
        return {"x": x - gamma * (hbar + Mbar), "h": h + alpha_lr * M,
                "hbar": hbar + alpha_lr * Mbar}

    state = {"x": _zeros(prob, d), "h": _zeros(prob, n, d),
             "hbar": _zeros(prob, d)}
    return _trace_loop(prob, num_rounds, step, state, k, d, "diana",
                       record_every)


# --------------------------------------------------------------------------
# EF21 with top-k compression (biased, error feedback)
# --------------------------------------------------------------------------
def run_ef21(prob: FiniteSumProblem, gamma: float, k: int,
             num_rounds: int = 500, seed: int = 0,
             record_every: int = 1) -> dict:
    del seed  # no draws
    d = prob.d

    def step(state, r):
        x_new = state["x"] - gamma * state["g"].mean(dim=0)
        C = compression.top_k(prob.grad_all(x_new) - state["g"], k)
        return {"x": x_new, "g": state["g"] + C}

    x0 = _zeros(prob, d)
    # the paper's warm start g_i^0 = grad f_i(x^0)
    state = {"x": x0, "g": prob.grad_all(x0)}
    return _trace_loop(prob, num_rounds, step, state, k, d, "ef21",
                       record_every)


# --------------------------------------------------------------------------
# 5GCS (Grudzien et al. 2023): Point-SAGA over cohorts, the prox computed
# inexactly by local GD steps
# --------------------------------------------------------------------------
def run_5gcs(prob: FiniteSumProblem, gamma: float, c: int,
             inner_steps: int = 20, inner_lr: Optional[float] = None,
             num_rounds: int = 200, seed: int = 0,
             record_every: int = 1, cohorts=None) -> dict:
    """Each round the cohort computes ``prox_{gamma f_i}(z_i)`` by
    ``inner_steps`` GD steps on the prox subproblem, then the duals move
    SAGA-style.  The inner gradients are the cohort's rows only (the
    reference computes all n and keeps the cohort's: the same values)."""
    n, d = prob.n, prob.d
    inner_lr = (inner_lr if inner_lr is not None
                else 1.0 / (prob.L + 1.0 / gamma))
    cohort_of = _schedule(
        cohorts, lambda r: compression.split_cohort(seed, r, n, c)[0])

    def step(state, r):
        x, U, ubar = state["x"], state["U"], state["ubar"]
        cohort = _index(prob, cohort_of(r))
        data = prob.cohort_data(cohort)
        z = x[None, :] + gamma * (U[cohort] - ubar[None, :])  # (c, d)
        Y = z
        for _ in range(inner_steps):
            Y = Y - inner_lr * (prob.grads(Y, data) + _div(Y - z, gamma))
        u_new = _div(z - Y, gamma)  # ~ grad f_i(prox)
        du = u_new - U[cohort]
        U[cohort] = u_new
        return {"x": Y.mean(dim=0), "U": U,
                "ubar": ubar + _div(du.sum(dim=0), n)}

    state = {"x": _zeros(prob, d), "U": _zeros(prob, n, d),
             "ubar": _zeros(prob, d)}
    return _trace_loop(prob, num_rounds, step, state, d, d, "5gcs",
                       record_every)
