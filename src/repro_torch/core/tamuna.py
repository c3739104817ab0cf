"""TAMUNA, Algorithm 1 of the paper (the port of ``repro.core.tamuna``).

One round over a ``FiniteSumProblem``:

* PP: a uniform cohort of ``c`` of the ``n`` clients; idle clients do
  nothing;
* LT: ``L`` local steps ``x <- x - gamma g + gamma h`` from ``x_bar``, with
  ``L ~ Geometric(p)`` (or fixed);
* CC: the UpCom ``x_bar = (1/s) sum_i C_i(x_i)`` through the permutation
  mask of sparsity ``s``, then the control-variate update
  ``h_i += (eta/gamma) C_i(x_bar - x_i)`` on the cohort.

Under the cyclic template (``d s >= c``) both applications of C_i are the
CUDA kernel ``kernels.compress.compress`` on the ``(c, d)`` cohort stack:
two launches per round, with no ``(d, c)`` mask.  The tall-and-thin
(``d s < c``) and blocked templates are other functions, which the kernel
does not compute: they build the mask with ``masks.mask_from_permutation``
in plain torch, as the reference does.

The state is ``x_bar (d,)`` and ``h (n, d)`` in float64 on the problem's
device, plus host counters.  ``round_step`` takes its draws (cohort, ``L``,
permutation, gradient noise, quantizer uniforms) as arguments and updates
``h`` in place.  ``run`` draws them: the cohort, ``L`` and the permutation
from numpy streams keyed by ``(seed, fold, round)`` on the host, which
therefore knows ``L`` and never waits for the device between record
points; the noise and the quantizer's uniforms from a device
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compression, masks, theory
from repro_torch.core.problems import F64, FiniteSumProblem
from repro_torch.kernels.compress import compress
from repro_torch.kernels.ref import _div

# stream tag of the local-step count: SeedSequence([seed, L_FOLD, r])
L_FOLD = 0x4C57

# round r -> (cohort (c,), L, permutation (c,))
Schedule = Callable[[int], Tuple[np.ndarray, int, np.ndarray]]


@dataclass(frozen=True)
class TamunaConfig:
    gamma: float  # local stepsize
    eta: float  # control-variate stepsize (Remark 2: eta = p * chi)
    p: float  # inverse expected number of local steps per round
    c: int  # cohort size (2 <= c <= n)
    s: int  # compression sparsity index (2 <= s <= c)
    geometric_L: bool = True  # L ~ Geom(p); else fixed L = round(1/p)
    sigma: float = 0.0  # stochastic gradient noise std-dev (per client)
    blocked_mask: bool = False  # contiguous-block template
    max_L: int = 100_000  # cap on geometric draws
    quantize_bits: int = 0  # stochastic rounding of the UpCom; 0 = off

    @staticmethod
    def tuned(prob: FiniteSumProblem, c: int, alpha: float = 0.0,
              **over) -> "TamunaConfig":
        """Theorem-3 tuned parameters for ``prob`` (eq. 12/14, Remark 2)."""
        tp = theory.TunedParams.for_problem(prob.mu, prob.L, prob.n, c,
                                            prob.d, alpha)
        cfg = TamunaConfig(gamma=tp.gamma, eta=tp.eta, p=tp.p, c=c, s=tp.s)
        return replace(cfg, **over) if over else cfg


@dataclass
class TamunaState:
    x_bar: torch.Tensor  # (d,) server model estimate
    h: torch.Tensor  # (n, d) control variates, sum_i h_i = 0
    round: int = 0
    total_local_steps: int = 0  # the paper's iteration count t
    up_floats: float = 0.0  # cumulative uplink floats per client
    down_floats: float = 0.0  # cumulative downlink floats per client


def init(prob: FiniteSumProblem,
         x0: Optional[torch.Tensor] = None) -> TamunaState:
    dev = prob.device
    x_bar = (torch.zeros(prob.d, dtype=F64, device=dev) if x0 is None
             else torch.as_tensor(x0, dtype=F64).to(dev).clone())
    return TamunaState(x_bar, torch.zeros(prob.n, prob.d, dtype=F64,
                                          device=dev))


def sample_L(cfg: TamunaConfig, seed: int, r: int) -> int:
    """The local-step count of round ``r``: ``1 + floor(log u / log(1 -
    p))`` with ``u ~ U[1e-12, 1)`` from ``SeedSequence([seed, L_FOLD, r])``,
    capped at ``max_L`` (``round(1/p)`` without ``geometric_L``)."""
    if not cfg.geometric_L:
        return max(1, round(1.0 / cfg.p))
    if cfg.p >= 1.0:
        return 1
    rng = np.random.default_rng(np.random.SeedSequence([seed, L_FOLD, r]))
    u = rng.uniform(1e-12, 1.0)
    return min(1 + math.floor(math.log(u) / math.log1p(-cfg.p)), cfg.max_L)


def draw_round(cfg: TamunaConfig, n: int, seed: int,
               r: int) -> Tuple[np.ndarray, int, np.ndarray]:
    """Round ``r``'s cohort, ``L`` and permutation from the port's streams."""
    return (compression.split_cohort(seed, r, n, cfg.c)[0],
            sample_L(cfg, seed, r), masks.sample_permutation(seed, r, cfg.c))


def round_step(prob: FiniteSumProblem, cfg: TamunaConfig, state: TamunaState,
               cohort, L: int, perm,
               noise: Optional[Callable[[int], torch.Tensor]] = None,
               qrnd: Optional[torch.Tensor] = None) -> TamunaState:
    """One TAMUNA round (Algorithm 1 lines 3-18) with the given draws:
    ``cohort`` ``(c,)`` client indices, ``L`` local steps, ``perm`` ``(c,)``
    the mask's column permutation (cohort member ``i`` takes template
    column ``perm[i]``), ``noise(l)`` the ``(c, d)`` standard normals of
    local step ``l`` (needed when ``sigma > 0``) and ``qrnd`` the ``(c, d)``
    uniforms of the quantizer (needed when ``quantize_bits``).  Updates
    ``state.h`` in place; the returned state shares it."""
    c, s, d = cfg.c, cfg.s, prob.d
    dev = state.h.device
    cohort = torch.as_tensor(np.asarray(cohort), dtype=torch.int64).to(dev)
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int32).to(dev)
    data = prob.cohort_data(cohort)
    h_cohort = state.h[cohort]
    X = state.x_bar.expand(c, d)
    for step in range(L):
        G = prob.grads(X, data)
        if cfg.sigma > 0.0:
            G = G + cfg.sigma * noise(step)
        X = X - cfg.gamma * G + cfg.gamma * h_cohort

    X_up = X
    if cfg.quantize_bits:
        X_up = compression.quantize_stochastic(X, cfg.quantize_bits, qrnd)
    scale = cfg.eta / cfg.gamma
    if not cfg.blocked_mask and d * s >= c:
        # the cyclic template: C_i is the kernel, slot i = perm[i]
        x_bar = _div(compress(X_up.contiguous(), perm, c, s).sum(dim=0), s)
        delta = scale * compress(x_bar[None, :] - X, perm, c, s)
    else:
        q = masks.mask_from_permutation(perm, d, c, s,
                                        blocked=cfg.blocked_mask)
        x_bar = compression.aggregate_masked(X_up, q, s)
        delta = scale * q.T.to(X.dtype) * (x_bar[None, :] - X)
    state.h.index_add_(0, cohort, delta)

    up = (masks.block_column_nnz(d, c, s) if cfg.blocked_mask
          else compression.uplink_floats_permutation(d, c, s))
    return TamunaState(
        x_bar=x_bar, h=state.h, round=state.round + 1,
        total_local_steps=state.total_local_steps + L,
        up_floats=state.up_floats + float(up),
        down_floats=state.down_floats + float(d))


def lyapunov(prob: FiniteSumProblem, cfg: TamunaConfig, state: TamunaState,
             h_star: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper eq. (6) Lyapunov function (chi recovered from eta = p chi);
    ``h_star`` defaults to ``prob.h_star()``."""
    chi = cfg.eta / cfg.p
    if h_star is None:
        h_star = prob.h_star()
    term_x = prob.n / cfg.gamma * torch.sum((state.x_bar - prob.x_star) ** 2)
    term_h = (cfg.gamma / (cfg.p ** 2 * chi) * (prob.n - 1) / (cfg.s - 1)
              * torch.sum((state.h - h_star) ** 2))
    return term_x + term_h


def run(prob: FiniteSumProblem, cfg: TamunaConfig, num_rounds: int,
        seed: int = 0, record_every: int = 1,
        x0: Optional[torch.Tensor] = None,
        schedule: Optional[Schedule] = None) -> dict:
    """Drive ``num_rounds`` rounds; return a trace dict.

    Records are taken after round ``r`` for ``r % record_every == 0`` and
    after the last round, as in the reference; ``seconds`` is the host
    time since the start at each record, which waits for the device there.
    ``schedule(r)`` replaces the port's draws of round ``r``'s cohort,
    ``L`` and permutation (a test injects the reference's)."""
    state = init(prob, x0)
    dev = prob.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = schedule or (lambda r: draw_round(cfg, prob.n, seed, r))
    shape = (cfg.c, prob.d)

    def noise(_step):
        return torch.randn(shape, generator=gen, dtype=F64, device=dev)

    record_pts = (set(range(0, num_rounds, max(1, record_every)))
                  | {num_rounds - 1}) if num_rounds > 0 else set()
    h_star = prob.h_star() if prob.x_star is not None else None
    trace = {k: [] for k in ("rounds", "suboptimality", "up_floats",
                             "down_floats", "local_steps", "lyapunov",
                             "seconds")}
    t0 = time.perf_counter()
    for r in range(num_rounds):
        cohort, L, perm = draw(r)
        qrnd = (torch.rand(shape, generator=gen, dtype=F64, device=dev)
                if cfg.quantize_bits else None)
        state = round_step(prob, cfg, state, cohort, L, perm,
                           noise=noise if cfg.sigma > 0.0 else None,
                           qrnd=qrnd)
        if r not in record_pts:
            continue
        trace["rounds"].append(r + 1)
        trace["suboptimality"].append(float(prob.suboptimality(state.x_bar)))
        trace["up_floats"].append(int(state.up_floats))
        trace["down_floats"].append(int(state.down_floats))
        trace["local_steps"].append(state.total_local_steps)
        if h_star is not None:
            trace["lyapunov"].append(
                float(lyapunov(prob, cfg, state, h_star)))
        trace["seconds"].append(time.perf_counter() - t0)
    out = {k: np.array(v) for k, v in trace.items()}
    out.update(algo="tamuna", state=state)
    return out
