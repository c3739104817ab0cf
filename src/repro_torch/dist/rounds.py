"""The synchronous round driver (``repro.dist.rounds.run_rounds`` without
pipelining).

Per round ``g`` (the global round, ``state.round`` at entry plus the loop
index): draw ``L ~ Geometric(p)`` capped at ``max_L`` from the host numpy
RNG and the template permutation (``uplink="masked_psum"``) or the shift
``off`` (``"block_rs"``) from a ``torch.Generator``; take the round's
cohort and the next round's (the DownCom targets only joining clients);
run L local steps on the cohort's rows, then the comm step.  With
``elastic=False`` (the all-rows round) every row trains L steps on its own
batch, the cohort still sets the template's ownership, and the DownCom
goes to every row.  ``checkpoint_dir``/``checkpoint_every`` save the state
as ``step_<g + 1>`` after every ``checkpoint_every``-th round
(``checkpoint.save_state``, the reference's format); the host streams are
not saved, as in the reference.

Cohorts come from a ``cohort.CohortPlan`` when one is given, else from a
port-owned numpy stream that is a pure function of ``(seed, g, attempt)``
(``uniform_cohort``): the fault resolver memoizes and re-resolves rounds,
so a cohort must not depend on the order of queries.  On the quantized
wire the round's uint32 wire seed comes from another such stream
(``wire_seed``); the f32 wire draws nothing from it.

With a ``faults.FaultPlan`` the round is the fault-tolerant one (DESIGN.md
§12 and §15 of the reference): the host resolves each round's survivors
from the plan's replayable draws (retrying a missed quorum with a fresh
cohort), then, on the trained state and in this order, the corrupted rows
are injected, the Byzantine rows are injected, the payload guard demotes
nonfinite (and, adaptive, magnitude-outlier) members and zeroes their rows,
and the comm step aggregates the arrived rows.  The workspace is updated in
place, so, as in the reference, a corrupted row that is neither zeroed nor
overwritten by the DownCom stays corrupted.  With a reputation the anomaly
scores of the arrived rows are taken after the guard and before the comm
step, and the EWMA's quarantine windows feed back into the ``CohortPlan``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist import faults as faults_mod
from repro_torch.dist import robust as robust_mod
from repro_torch.dist import tamuna_dp
from repro_torch.dist import wire as wire_mod
from repro_torch.models.transformer import ModelConfig

ROUND_POLICIES = ("wait_all", "quorum", "deadline")

_TAG_COHORT = 223  # SeedSequence tag of the uniform cohort stream


def default_elastic(n: int, c: int) -> bool:
    """Whether the round gathers the cohort by default: the reference's
    ``rounds.default_elastic`` on one device (``dp_total = 1``), which is
    exactly ``c < n``."""
    return c < n


def uniform_cohort(seed: int, n: int, c: int, rnd: int,
                   attempt: int = 0) -> np.ndarray:
    """Uniform sorted ``(c,)`` int32 cohort of round ``rnd``: a pure
    function of ``(seed, rnd, attempt)``."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), _TAG_COHORT, int(rnd),
                                int(attempt)]))
    return np.sort(rng.permutation(n)[:c]).astype(np.int32)


def wire_seed(seed: int, rnd: int, attempt: int = 0) -> int:
    """The uint32 wire seed of round ``rnd``: a pure function of ``(seed,
    rnd, attempt)`` on a stream tagged ``wire.WIRE_FOLD``."""
    ss = np.random.SeedSequence([int(seed), wire_mod.WIRE_FOLD, int(rnd),
                                 int(attempt)])
    return int(ss.generate_state(1, np.uint32)[0])


def _make_fault_resolver(faults, *, n: int, policy: str, q, max_retries: int,
                         backoff0: float, deadline, host_cohort):
    """Host-side survivor resolution.  ``resolve(g)`` returns a dict with
    cohort/member/arrived/corrupt masks plus retry accounting; results are
    memoized in ``resolve.cache`` (the quarantine feedback purges entries
    past the detection round)."""
    resolved: Dict[int, Any] = {}

    def resolve(g: int):
        got = resolved.get(g)
        if got is not None:
            return got
        attempt, backoff, quorum_miss = 0, 0.0, 0
        while True:
            cohort = host_cohort(g, attempt)
            member = np.zeros(n, bool)
            member[cohort] = True
            arrived = member & ~faults.drops(g, attempt)
            if policy == "deadline":
                arrived &= faults.delays(g, attempt) <= deadline
            if (policy == "quorum" and int(arrived.sum()) < q
                    and attempt < max_retries):
                quorum_miss += 1
                backoff += backoff0 * (2.0 ** attempt)
                attempt += 1
                continue
            break
        res = {
            "cohort": cohort,
            "member": member,
            "arrived": arrived,
            "corrupt": faults.corrupts(g, attempt) & member,
            "retries": attempt,
            "backoff": backoff,
            "quorum_miss": quorum_miss,
        }
        resolved[g] = res
        return res

    resolve.cache = resolved
    return resolve


def _faulty_uplink(x: torch.Tensor, res: Dict[str, Any], byz, model, *,
                   guard: bool, guard_mode: str,
                   guard_max_abs: Optional[float]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The fault branch of a round before its comm step, in place on the
    ``(n, d)`` workspace ``x``: inject the corruption, then the Byzantine
    payloads, then run the payload guard and zero the rows it demotes.
    Returns the ``(n,)`` bool arrived rows and the guard's verdict."""
    member = res["member"]
    if model.p_corrupt > 0:
        faults_mod.corrupt_rows(x, res["corrupt"], model.corrupt_mode,
                                model.blowup)
    arr = res["arrived"] & member
    if byz is not None:
        # Byzantine rows only matter if they arrive; the inlier attack
        # colludes against the arrived honest rows
        faults_mod.adversarial_rows(x, byz & arr, arr & ~byz,
                                    model.adversary,
                                    byz_scale=model.byz_scale,
                                    byz_z=model.byz_z)
    bad = np.zeros(len(member), bool)
    if guard:
        bad = faults_mod.nonfinite_clients(x, member, guard_max_abs)
        if guard_mode == "adaptive":
            bad |= robust_mod.magnitude_outliers(x, arr & ~bad) & member
        arr = arr & ~bad
        for i in np.flatnonzero(bad).tolist():
            x[i].zero_()
    return arr, bad


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
    plan=None,
    faults=None,
    policy: str = "wait_all",
    quorum: Optional[int] = None,
    max_retries: int = 3,
    backoff0: float = 1.0,
    deadline: Optional[float] = None,
    quarantine_rounds: int = 0,
    guard: Optional[bool] = None,
    guard_max_abs: Optional[float] = None,
    guard_mode: Optional[str] = None,
    reputation=None,
    elastic: Optional[bool] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
) -> Tuple[tamuna_dp.DistTamunaState, List[Dict[str, Any]]]:
    """Run ``rounds`` rounds on ``state`` in place.

    ``rng`` draws the round lengths, ``generator`` (a CPU
    ``torch.Generator``) the permutations or shifts and, through its seed,
    the uniform cohorts and the wire seeds; ``plan`` (a
    ``cohort.CohortPlan``) replaces the uniform cohorts; ``pipe`` draws
    the batches.  ``tcfg`` carries the local optimizer, the microbatches,
    the uplink and the comm impl.  Returns the state and
    one metrics row per round; a row's ``seconds`` is the round's wall
    time up to a device synchronisation.

    ``elastic`` (default ``default_elastic(n, c)``: gather when ``c <
    n``) ``False`` runs the all-rows round: every row trains on its own
    batch and every row receives the DownCom.  ``checkpoint_every > 0``
    saves ``checkpoint_dir/step_<g + 1>`` after each such round.

    ``faults`` (a ``faults.FaultPlan``) turns on the fault-tolerant round,
    with the reference's policies: ``wait_all`` aggregates whatever
    arrives with the 1/s rebuild (under a zero-fault plan it is the
    fault-free round, bitwise); ``quorum`` needs ``quorum`` arrivals
    (default ``c // 2 + 1``), else retries with a fresh cohort up to
    ``max_retries`` times with simulated exponential backoff
    (``backoff0 * 2**attempt`` s, accounted, never slept); ``deadline``
    admits uplinks whose drawn delay is ``<= deadline``.  Both aggregate
    the survivors only.  ``guard`` (default: on iff the model corrupts or
    carries an adversary) demotes members whose payload fails the guard;
    ``guard_mode`` is ``"nonfinite"`` or ``"adaptive"`` (default adaptive
    when the model can send finite garbage and ``guard_max_abs`` is
    unset).  ``quarantine_rounds > 0`` (needs ``plan``) keeps a demoted
    client out of the cohorts of rounds ``g + 2 .. g + 1 +
    quarantine_rounds``.  Fault rows add ``arrivals``, ``corrupted``,
    ``retries``, ``backoff_s``, ``quorum_miss`` and ``round_latency_s``.

    ``reputation`` (``True`` or a ``robust.Reputation``; needs ``plan``
    and ``faults``) turns on the anomaly feedback loop: each round's
    ``robust.anomaly_scores`` of the arrived rows feed the EWMA over the
    arrived, unguarded clients, and each window it emits quarantines its
    client over rounds ``g + 2 .. g + 1 + w``; rows add ``anomaly_max``.
    Pass a ``Reputation`` restored by ``from_state_dict`` to resume its
    schedule.
    """
    n, c = state.x.shape[0], tcfg.c
    if policy not in ROUND_POLICIES:
        raise ValueError(f"unknown policy {policy!r}; pick from "
                         f"{ROUND_POLICIES}")
    adversarial = faults is not None and faults.model.adversarial
    if guard is None:
        guard = faults is not None and (faults.model.p_corrupt > 0
                                        or adversarial)
    if guard_mode is None:
        # the nonfinite check admits FINITE garbage (blowup rows,
        # adversarial payloads) whenever guard_max_abs is unset
        guard_mode = ("adaptive" if bool(guard) and guard_max_abs is None
                      and faults is not None
                      and (adversarial
                           or (faults.model.p_corrupt > 0
                               and faults.model.corrupt_mode == "blowup"))
                      else "nonfinite")
    if guard_mode not in ("nonfinite", "adaptive"):
        raise ValueError(f"unknown guard_mode {guard_mode!r}; pick "
                         "'nonfinite' or 'adaptive'")
    faulted = faults is not None and (
        not faults.is_zero or policy != "wait_all"
        or quarantine_rounds > 0 or bool(guard)
    )
    if faults is None and (policy != "wait_all" or quarantine_rounds > 0):
        raise ValueError("round policies and quarantine need a fault plan")
    if policy == "deadline" and deadline is None:
        raise ValueError("deadline policy needs a deadline (seconds)")
    if quarantine_rounds > 0 and plan is None:
        raise ValueError("quarantine needs a CohortPlan to feed back into")
    if faulted and faults.n != n:
        raise ValueError(f"fault plan covers {faults.n} clients, the state "
                         f"has n={n}")
    rep = None
    if reputation is not None and reputation is not False:
        if plan is None or faults is None or not faulted:
            raise ValueError("reputation feedback needs a CohortPlan and "
                             "a fault plan")
        rep = (reputation if isinstance(reputation, robust_mod.Reputation)
               else robust_mod.Reputation(n))
        if rep.n != n:
            raise ValueError(f"reputation covers {rep.n} clients, the "
                             f"state has n={n}")
    if plan is not None and getattr(plan, "weighted", False):
        # the aggregation never reweights by 1/(n p_i)
        warnings.warn(
            "CohortPlan has non-uniform selection weights but run_rounds "
            "aggregates without 1/(n p_i) importance reweighting; the "
            "fixed point is biased toward frequently-sampled clients",
            UserWarning, stacklevel=2,
        )

    if elastic is None:
        elastic = default_elastic(n, c)
    if checkpoint_every and not checkpoint_dir:
        raise ValueError("checkpoint_every needs a checkpoint_dir")
    blocked = tcfg.uplink == "block_rs"
    dev = state.x.device
    local = tamuna_dp.make_local_step(cfg, tcfg)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=dev)
    seed = generator.initial_seed()
    on_wire = wire_mod.is_wire(tcfg.wire_precision)

    def host_cohort(g: int, attempt: int = 0) -> np.ndarray:
        if plan is not None:
            return np.asarray(plan.cohort(g, attempt))
        return uniform_cohort(seed, n, c, g, attempt)

    resolve = None
    if faulted:
        resolve = _make_fault_resolver(
            faults, n=n, policy=policy,
            q=quorum if quorum is not None else c // 2 + 1,
            max_retries=max_retries, backoff0=backoff0, deadline=deadline,
            host_cohort=host_cohort)
    byz = faults.byzantine if faulted and adversarial else None

    start = state.round
    rows: List[Dict[str, Any]] = []
    total_steps = 0
    for r in range(rounds):
        t0 = time.perf_counter()
        g = start + r
        L = tamuna_dp.sample_round_length(rng, tcfg.p, max_L=max_L)
        if blocked:
            tmpl = dict(perm=None, off=int(torch.randint(
                0, c, (1,), generator=generator)))
        else:
            tmpl = dict(perm=torch.randperm(c, generator=generator).tolist())
        if faulted:
            res = resolve(g)
            cohort, nxt = res["cohort"], resolve(g + 1)["member"]
        else:
            cohort = host_cohort(g)
            nxt = tamuna_dp.member_mask(host_cohort(g + 1), n)
        # the all-rows round trains every row, so every row must re-sync
        trained = cohort if elastic else np.arange(n)
        if not elastic:
            nxt = None
        compact = tamuna_dp.gather_cohort(state, trained)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(L):
            batch = pipe.sample_batch(trained)
            loss_sum = loss_sum + local(compact, **batch)["loss"]
        state = tamuna_dp.scatter_cohort(state, compact)
        wseed = (wire_seed(seed, g, res["retries"] if faulted else 0)
                 if on_wire else None)
        if faulted:
            arr, bad = _faulty_uplink(
                state.x, res, byz, faults.model, guard=bool(guard),
                guard_mode=guard_mode, guard_max_abs=guard_max_abs)
            if rep is not None:  # before the comm step's DownCom
                anom = robust_mod.anomaly_scores(state.x, arr)
            state = comm(state, cohort, down=nxt, arrived=arr,
                         correct=policy != "wait_all", wire_seed=wseed,
                         **tmpl)
        else:
            state = comm(state, cohort, down=nxt, wire_seed=wseed, **tmpl)
        loss = float(loss_sum) / L  # waits for the device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        total_steps += L
        row = {
            "round": g, "L": L, "loss": loss, "local_steps": total_steps,
            # the f32 counters as Python floats, as the reference's rows
            "up_floats": float(state.up_floats),
            "down_floats": float(state.down_floats),
            "up_bytes": float(state.up_bytes),
            "down_bytes": float(state.down_bytes),
            "seconds": time.perf_counter() - t0,
        }
        if faulted:
            row.update({
                "arrivals": int(arr.sum()),
                "corrupted": int(bad.sum()),
                "retries": res["retries"],
                "backoff_s": res["backoff"],
                "quorum_miss": res["quorum_miss"],
                "round_latency_s": float(
                    faults.delays(g, res["retries"])[res["arrived"]].max()
                    if res["arrived"].any() else 0.0
                ) + res["backoff"],
            })
            if quarantine_rounds > 0 and bad.any():
                # must land before round g+2's cohort is resolved (g+1's
                # is this round's DownCom target already)
                plan.quarantine(np.flatnonzero(bad), g + 2,
                                g + 1 + quarantine_rounds)
                for k in [k for k in resolve.cache if k >= g + 2]:
                    del resolve.cache[k]
            if rep is not None:
                row["anomaly_max"] = float(anom.max())
                # guard-demoted rows were zeroed: their score is a
                # meaningless 0, so they stay out of the EWMA; the windows
                # land before round g+2's cohort is resolved
                wins = rep.update(anom, res["arrived"] & ~bad)
                for cid, w in wins:
                    plan.quarantine([cid], g + 2, g + 1 + w)
                if wins:
                    for k in [k for k in resolve.cache if k >= g + 2]:
                        del resolve.cache[k]
        rows.append(row)
        if logger is not None:
            logger.log(g, row)
        if checkpoint_every and (r + 1) % checkpoint_every == 0:
            from repro_torch import checkpoint

            checkpoint.save_state(
                os.path.join(checkpoint_dir, f"step_{g + 1}"), state, g + 1)
    return state, rows
