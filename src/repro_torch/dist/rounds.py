"""The synchronous round driver (``repro.dist.rounds.run_rounds`` without
faults, plans, pipelining or checkpoints).

Per round: draw ``L ~ Geometric(p)`` capped at ``max_L`` from the host
numpy RNG, draw the template permutation and the next round's cohort from a
``torch.Generator``, gather the cohort, run L local steps on it, then the
comm step whose DownCom targets the next round's cohort (only joining
clients download; clients out of both cohorts are untouched).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist import tamuna_dp
from repro_torch.models.transformer import ModelConfig


def draw_cohort(generator: torch.Generator, n: int, c: int) -> List[int]:
    """Uniform sorted cohort of ``c`` out of ``n`` clients."""
    return sorted(torch.randperm(n, generator=generator)[:c].tolist())


def run_rounds(
    state: tamuna_dp.DistTamunaState,
    *,
    cfg: ModelConfig,
    tcfg: tamuna_dp.DistTamunaConfig,
    pipe: SyntheticTokenPipeline,
    rounds: int,
    rng: np.random.Generator,
    generator: torch.Generator,
    max_L: int = 16,
    logger=None,
) -> Tuple[tamuna_dp.DistTamunaState, List[Dict[str, Any]]]:
    """Run ``rounds`` rounds on ``state`` in place.

    ``rng`` draws the round lengths, ``generator`` (a CPU
    ``torch.Generator``) the cohorts and permutations, ``pipe`` the
    batches.  Returns the state and one metrics row per round; a row's
    ``seconds`` is the round's wall time up to a device synchronisation."""
    n, c = state.x.shape[0], tcfg.c
    dev = state.x.device
    local = tamuna_dp.make_local_step(cfg, tcfg)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=dev)
    cohort = draw_cohort(generator, n, c)
    rows: List[Dict[str, Any]] = []
    total_steps = 0
    for r in range(rounds):
        t0 = time.perf_counter()
        L = tamuna_dp.sample_round_length(rng, tcfg.p, max_L=max_L)
        perm = torch.randperm(c, generator=generator).tolist()
        nxt = draw_cohort(generator, n, c)
        compact = tamuna_dp.gather_cohort(state, cohort)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(L):
            batch = pipe.sample_batch(cohort)
            loss_sum = loss_sum + local(compact, **batch)["loss"]
        state = tamuna_dp.scatter_cohort(state, compact)
        state = comm(state, cohort, perm, tamuna_dp.member_mask(nxt, n))
        loss = float(loss_sum) / L  # waits for the device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        total_steps += L
        row = {
            "round": r, "L": L, "loss": loss, "local_steps": total_steps,
            "up_floats": state.up_floats, "down_floats": state.down_floats,
            "up_bytes": state.up_bytes, "down_bytes": state.down_bytes,
            "seconds": time.perf_counter() - t0,
        }
        rows.append(row)
        if logger is not None:
            logger.log(r, row)
        cohort = nxt
    return state, rows
