"""The round drivers (``repro.dist.rounds``): the synchronous
``run_rounds`` and the pipelined ``run_rounds_pipelined``, both over the
split-phase round of ``make_pipelined_round_fn`` (``stage``: the cohort's
local steps; ``commit``: scatter, faults and guard, comm step).

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

``run_rounds_pipelined`` (DESIGN.md §14 of the reference) keeps up to
``staleness`` rounds in flight: each pipeline step stages one round and
commits the one ``staleness`` rounds older, with disjoint in-flight
cohorts, the DownCom prefetched to the next cohort to stage, admission
by a simulated straggler clock, and checkpoints of the pipeline mid-flight
(``pipeline_checkpoint_save``/``restore`` under ``pipe_step_<k>``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import types
import warnings
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch._device import upload
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist import faults as faults_mod
from repro_torch.dist import robust as robust_mod
from repro_torch.dist import sharding, tamuna_dp
from repro_torch.dist import wire as wire_mod
from repro_torch.dist.sharding import Mesh2D, RankRows
from repro_torch.models.transformer import ModelConfig

ROUND_POLICIES = ("wait_all", "quorum", "deadline")

_TAG_COHORT = 223  # SeedSequence tag of the uniform cohort stream
_TAG_FREE = 229  # of the busy-aware uniform cohort of the pipelined driver


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


def _check_policy(policy: str) -> None:
    if policy not in ROUND_POLICIES:
        raise ValueError(f"unknown policy {policy!r}; pick from "
                         f"{ROUND_POLICIES}")


def _resolve_guard(faults, guard, guard_max_abs, guard_mode):
    """Both drivers' payload guard: ``guard`` defaults to on iff the fault
    model corrupts or carries an adversary; ``guard_mode`` to adaptive
    when the model can send finite garbage and ``guard_max_abs`` is unset.
    Returns ``(guard, guard_mode, adversarial)``."""
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
    return guard, guard_mode, adversarial


def _host_cohort(plan, seed: int, n: int, c: int):
    """``host_cohort(g, attempt=0)``: round ``g``'s cohort from ``plan``,
    else the uniform stream of ``seed``."""
    def host_cohort(g: int, attempt: int = 0) -> np.ndarray:
        if plan is not None:
            return np.asarray(plan.cohort(g, attempt))
        return uniform_cohort(seed, n, c, g, attempt)

    return host_cohort


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


def _sum_over_ranks(group: Optional[RankRows], v: np.ndarray,
                    dev) -> np.ndarray:
    """``v`` (``(n,)``, this rank's entries, zeros elsewhere) summed over
    the ranks as f32 on ``dev``; ``v`` itself without a group."""
    if group is None:
        return v
    t = torch.as_tensor(np.asarray(v, np.float32)).to(dev)
    return group.all_reduce(t).cpu().numpy()


def _faulty_uplink(x: torch.Tensor, member: np.ndarray, arrived, corrupt,
                   byz, model, *, dtype: torch.dtype, guard: bool,
                   guard_mode: str, guard_max_abs: Optional[float],
                   group: Optional[RankRows] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The fault branch of a round before its comm step, in place on the
    ``(n, d)`` workspace ``x``: inject the corruption (the ``corrupt``
    rows, when given), then the Byzantine payloads (the arrived ``byz``
    rows, when given), round the member rows to the parameters' storage
    ``dtype`` (``tamuna_dp.store_rows``: the reference writes the payloads
    in it), then run the payload guard over the ``member`` rows and zero
    the rows it demotes.  Every step reads and writes only member rows.
    ``model`` (a ``faults.FaultModel``) carries the modes.  Returns the
    ``(n,)`` bool arrived rows and the guard's verdict.

    With ``group`` the workspace holds a rank's rows (the masks stay
    global): each rank injects and guards the members it hosts, and the
    guard's per-client flags (and the adaptive guard's payload norms) are
    summed over the ranks, so every rank reaches the same verdict."""
    rows = sharding.local_rows(group, len(member))
    if corrupt is not None:
        faults_mod.corrupt_rows(x, np.asarray(corrupt, bool)[rows],
                                model.corrupt_mode, model.blowup)
    arr = np.asarray(arrived, bool) & member
    if byz is not None:
        if group is not None and model.adversary == "inlier":
            raise ValueError(
                "the inlier attack over ranks is not ported (ROADMAP "
                "A9d): it needs every rank's arrived honest rows")
        # Byzantine rows only matter if they arrive; the inlier attack
        # colludes against the arrived honest rows
        faults_mod.adversarial_rows(x, (byz & arr)[rows],
                                    (arr & ~byz)[rows], model.adversary,
                                    byz_scale=model.byz_scale,
                                    byz_z=model.byz_z)
    tamuna_dp.store_rows(x, member[rows], dtype)
    bad = np.zeros(len(member), bool)
    if guard:
        bad[rows] = faults_mod.nonfinite_clients(x, member[rows],
                                                 guard_max_abs)
        bad = _sum_over_ranks(group, bad, x.device) > 0
        if guard_mode == "adaptive":
            live = arr & ~bad
            norms = np.zeros(len(member), np.float32)
            norms[rows] = robust_mod.payload_norms(x, live[rows]).numpy()
            norms = torch.from_numpy(_sum_over_ranks(group, norms,
                                                     x.device))
            bad |= robust_mod.norm_outliers(norms, live) & member
        arr = arr & ~bad
        for i in np.flatnonzero(bad[rows]).tolist():
            x[i].zero_()
    return arr, bad


def make_pipelined_round_fn(cfg: ModelConfig,
                            tcfg: tamuna_dp.DistTamunaConfig, n: int, *,
                            pipe: SyntheticTokenPipeline, max_L: int = 16,
                            elastic: Optional[bool] = None,
                            coverage: bool = True, device="cuda",
                            group: Union[RankRows, Mesh2D, None] = None):
    """The round in two halves (``rounds.make_pipelined_round_fn``), which
    ``run_rounds`` calls back to back and ``run_rounds_pipelined``
    interleaves.  Returns a namespace with ``stage``, ``commit``,
    ``template``, ``n``, ``c``, ``max_L``, ``elastic``, ``coverage``,
    ``blocked``, ``on_wire`` and ``pipe``.

    ``stage(state, L, cohort) -> buf`` takes the cohort's rows (all rows
    when not ``elastic``) and runs ``min(L, max_L)`` local steps on them,
    each on a batch from ``pipe``; ``buf`` is ``{"compact", "loss",
    "steps"}`` with the summed loss as a device scalar.  The reference
    stages into a compact copy while the full state advances underneath;
    here the compact rows are views of the workspace rows
    (``tamuna_dp.gather_cohort``), trained in place.  That is sound because
    the driver keeps in-flight cohorts disjoint, the DownCom of a commit
    goes to the next cohort to stage, and a stage finishes its local steps
    before the next commit runs: every step of a commit reads and writes
    only its own members' rows and its ``down`` rows.

    ``commit(state, buf, cohort, down, *, perm=None, off=None, ...) ->
    (state, info)`` scatters the rows back (AdamW's shared count
    last-wins), then, when ``arrived`` is given, injects the ``corrupt``
    and ``byz`` rows by ``model`` (a ``faults.FaultModel``) and runs the
    payload guard (``_faulty_uplink``), takes the anomaly scores when
    ``anomaly``, and runs the comm step with the round's ``perm`` or
    ``off`` and ``wire_seed``.  ``info`` holds ``arrived``, ``bad``,
    ``anomaly`` and, when ``coverage`` is on, ``uncovered`` on faulted
    commits.  ``template(generator)`` draws a round's ``{"perm", "off"}``
    from a ``torch.Generator``.

    ``group`` (a ``sharding.RankRows`` of ``n``): the state holds a rank's
    rows.  ``stage`` then draws every step's batch for the whole cohort
    (the pipe's draws depend on the cohort's make-up), trains the members
    the rank hosts, and returns ``loss`` as a ``(steps, c)`` tensor of the
    members' losses in their cohort slots, zeros for the members hosted
    elsewhere (summed over the ranks at the driver's drain); ``commit``
    guards the rank's rows and runs the shard engine.  A ``sharding.Mesh2D``
    ``group`` adds the model axis (``run_rounds``)."""
    group, mesh = sharding.split_group(group)
    c = tcfg.c
    if c > n:
        raise ValueError(f"cohort c={c} exceeds population n={n}")
    if elastic is None:
        elastic = default_elastic(n, c)
    blocked = tcfg.uplink == "block_rs"
    local = tamuna_dp.make_local_step(cfg, tcfg, mesh)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device,
                                    with_stats=coverage, group=group,
                                    mesh=mesh)

    def template(generator: torch.Generator) -> Dict[str, Any]:
        if blocked:
            return {"perm": None, "off": int(torch.randint(
                0, c, (1,), generator=generator))}
        return {"perm": torch.randperm(c, generator=generator).tolist(),
                "off": None}

    def stage(state, L: int, cohort=None) -> Dict[str, Any]:
        if elastic:
            if cohort is None:
                raise ValueError("elastic stage needs a host-resolved "
                                 "cohort (the driver owns the schedule)")
            rows = cohort
        else:
            # the all-rows body: every row trains on its own batch
            rows = np.arange(n)
        steps = max(1, min(int(L), max_L))
        dev = state.x.device
        if group is not None:
            hosted = [a for a, i in enumerate(rows) if group.hosts(i)]
            compact = tamuna_dp.gather_cohort(
                state, [int(rows[a]) - group.row0 for a in hosted])
            idx = upload(hosted, dev, torch.long)
            loss = torch.zeros(steps, len(rows), dtype=torch.float32,
                               device=dev)
            for k in range(steps):
                batch = pipe.sample_batch(rows)
                out = local(compact, **{key: v.index_select(0, idx)
                                        for key, v in batch.items()})
                loss[k].index_copy_(0, idx, out["losses"])
            return {"compact": compact, "loss": loss, "steps": steps}
        compact = tamuna_dp.gather_cohort(state, rows)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(steps):
            loss = loss + local(compact, **pipe.sample_batch(rows))["loss"]
        return {"compact": compact, "loss": loss, "steps": steps}

    def commit(state, buf, cohort, down=None, *, perm=None, off=None,
               arrived=None, corrupt=None, byz=None, model=None,
               correct: bool = True, guard: bool = False,
               guard_mode: str = "nonfinite",
               guard_max_abs: Optional[float] = None, wire_seed=None,
               anomaly: bool = False):
        state = tamuna_dp.scatter_cohort(state, buf["compact"])
        if not elastic:
            down = None  # every row trained, so every row re-syncs
        info: Dict[str, Any] = {}
        if arrived is None:
            if corrupt is not None:
                raise ValueError("corrupt mask needs an arrived mask")
            arr = None
        else:
            member = np.zeros(n, bool)
            member[np.asarray(cohort)] = True
            arr, bad = _faulty_uplink(
                state.x, member, arrived, corrupt, byz, model,
                dtype=cfg.param_dtype, guard=guard, guard_mode=guard_mode,
                guard_max_abs=guard_max_abs, group=group)
            info.update(arrived=arr, bad=bad)
            if anomaly:  # before the comm step's DownCom
                info["anomaly"] = robust_mod.anomaly_scores(state.x, arr)
        out = comm(state, cohort, perm, down, arr, correct, wire_seed,
                   off=off)
        if coverage:
            state, stats = out
            if arr is not None:
                info["uncovered"] = stats["uncovered"]
        else:
            state = out
        return state, info

    return types.SimpleNamespace(
        stage=stage, commit=commit, template=template, n=n, c=c,
        max_L=max_L, elastic=elastic, coverage=coverage, blocked=blocked,
        on_wire=wire_mod.is_wire(tcfg.wire_precision), pipe=pipe,
        group=group)


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
    flush_every: int = 10,
    group: Union[RankRows, Mesh2D, None] = None,
) -> Tuple[tamuna_dp.DistTamunaState, List[Dict[str, Any]]]:
    """Run ``rounds`` rounds on ``state`` in place.

    ``rng`` draws the round lengths, ``generator`` (a CPU
    ``torch.Generator``) the permutations or shifts and, through its seed,
    the uniform cohorts and the wire seeds; ``plan`` (a
    ``cohort.CohortPlan``) replaces the uniform cohorts; ``pipe`` draws
    the batches.  ``tcfg`` carries the local optimizer, the microbatches,
    the uplink and the comm impl.  Returns the state and
    one metrics row per round.

    Each round's loss sum stays on the device; every ``flush_every``
    rounds (clamped to ``[1, rounds]``, as the reference) and at the last
    round one device-to-host copy drains the window's losses (``_drain``).
    That copy is the fault-free round's only wait for the device: the
    cohort, slot and DownCom tables go up from pinned memory without
    blocking.  The rows are built at the drain, keys, values and order as
    at ``flush_every=1``, and the logger receives them there in round
    order.  A row's ``seconds`` is the round's host time; the last row of
    a window also carries the wait at the drain, so a window's rows add up
    to its wall time.  The round's own logic still reads the device where
    it must: the payload guard of a faulted round
    (``faults.nonfinite_clients``, ``robust.magnitude_outliers``), the
    anomaly scores of a reputation round
    (which feed the next cohorts), and a checkpoint save.  The fault
    resolution itself is host-side and reads nothing back.

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

    ``group`` (a ``sharding.RankRows``; ROADMAP A9a) runs the rounds data
    parallel: ``state`` holds the rank's rows of the population
    ``group.n`` (``tamuna_dp.init_state(rows=)``) and every rank calls
    ``run_rounds`` with the same arguments and streams.  Every rank draws
    the same schedule (L, cohorts, permutations or shifts, faults, wire
    seeds) and each step's batch for the whole cohort, trains the members
    it hosts and runs the shard engine; the members' losses are summed
    over the ranks at each drain, and the guard's flags in each faulted
    round, so every rank builds the same rows (only rank 0 logs them).
    At ``s = 2`` the state and the rows are the one-process run's
    bitwise.  The reputation, checkpoints and the pipelined driver over
    ranks are not ported (ROADMAP A9d) and raise.

    ``group`` may also be a ``sharding.Mesh2D`` (ROADMAP A9b): ``state``
    then holds the rank's rows of its data group and its model rank's
    blocks of the leaves (``tamuna_dp.init_state(mesh=)``), the local
    steps run the tensor-parallel layers and the comm step runs on the
    blocks (``tamuna_dp.make_comm_step(mesh=)``); every rank draws the
    same schedule and batches, and the losses, the same on every model
    rank, are summed over the data group only.  The fault-tolerant round
    over model blocks is not ported (ROADMAP A9d) and raises.
    """
    c = tcfg.c
    group, mesh = sharding.split_group(group)
    if group is None:
        n = state.x.shape[0]
    else:
        n = group.n
        if state.x.shape[0] != group.local:
            raise ValueError(f"rank {group.rank} holds {group.local} rows "
                             f"of {n}; the state has {state.x.shape[0]}")
        if reputation is not None and reputation is not False:
            raise ValueError("the reputation over ranks is not ported "
                             "(ROADMAP A9d): its anomaly scores need "
                             "every arrived row")
        if checkpoint_dir or checkpoint_every:
            raise ValueError("checkpoints over ranks are not ported "
                             "(ROADMAP A9d): the reference's checkpoint "
                             "gathers the whole state")
    _check_policy(policy)
    guard, guard_mode, adversarial = _resolve_guard(
        faults, guard, guard_max_abs, guard_mode)
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
    if faulted and mesh is not None and mesh.mp > 1:
        raise ValueError("the fault-tolerant round over model blocks is "
                         "not ported (ROADMAP A9d): its guard reads whole "
                         "rows")
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
    flush_every = max(1, min(int(flush_every), rounds))
    dev = state.x.device
    engine = make_pipelined_round_fn(cfg, tcfg, n, pipe=pipe, max_L=max_L,
                                     elastic=elastic, coverage=False,
                                     device=dev,
                                     group=group if mesh is None else mesh)
    if group is not None and group.rank != 0:
        logger = None  # every rank builds the same rows; rank 0 logs
    seed = generator.initial_seed()
    host_cohort = _host_cohort(plan, seed, n, c)

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
    pending: List[Tuple[Dict[str, Any], torch.Tensor]] = []
    total_steps = 0
    for r in range(rounds):
        t0 = time.perf_counter()
        g = start + r
        L = tamuna_dp.sample_round_length(rng, tcfg.p, max_L=max_L)
        tmpl = engine.template(generator)
        if faulted:
            res = resolve(g)
            cohort, nxt = res["cohort"], resolve(g + 1)["member"]
        else:
            cohort = host_cohort(g)
            nxt = tamuna_dp.member_mask(host_cohort(g + 1), n)
        buf = engine.stage(state, L, cohort)
        wseed = (wire_seed(seed, g, res["retries"] if faulted else 0)
                 if engine.on_wire else None)
        if faulted:
            state, info = engine.commit(
                state, buf, cohort, nxt, **tmpl, arrived=res["arrived"],
                corrupt=(res["corrupt"] if faults.model.p_corrupt > 0
                         else None),
                byz=byz, model=faults.model, correct=policy != "wait_all",
                guard=bool(guard), guard_mode=guard_mode,
                guard_max_abs=guard_max_abs, wire_seed=wseed,
                anomaly=rep is not None)
            arr, bad = info["arrived"], info["bad"]
        else:
            state, _ = engine.commit(state, buf, cohort, nxt, **tmpl,
                                     wire_seed=wseed)
        total_steps += L
        row = {
            "round": g, "L": L, "loss": None, "local_steps": total_steps,
            # the f32 counters as Python floats, as the reference's rows
            "up_floats": float(state.up_floats),
            "down_floats": float(state.down_floats),
            "up_bytes": float(state.up_bytes),
            "down_bytes": float(state.down_bytes),
            "seconds": 0.0,
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
                row["anomaly_max"] = float(info["anomaly"].max())
                # guard-demoted rows were zeroed: their score is a
                # meaningless 0, so they stay out of the EWMA; the windows
                # land before round g+2's cohort is resolved
                wins = rep.update(info["anomaly"], res["arrived"] & ~bad)
                for cid, w in wins:
                    plan.quarantine([cid], g + 2, g + 1 + w)
                if wins:
                    for k in [k for k in resolve.cache if k >= g + 2]:
                        del resolve.cache[k]
        row["seconds"] = time.perf_counter() - t0
        pending.append((row, buf["loss"]))
        if len(pending) == flush_every or r == rounds - 1:
            t1 = time.perf_counter()
            _drain(pending, group)
            pending[-1][0]["seconds"] += time.perf_counter() - t1
            for row, _ in pending:
                rows.append(row)
                if logger is not None:
                    logger.log(row["round"], row)
            pending = []
        if checkpoint_every and (r + 1) % checkpoint_every == 0:
            from repro_torch import checkpoint

            checkpoint.save_state(
                os.path.join(checkpoint_dir, f"step_{g + 1}"), state, g + 1)
    return state, rows


def _drain(pending: List[Tuple[Dict[str, Any], torch.Tensor]],
           group: Optional[RankRows] = None) -> None:
    """Fill each pending row's ``loss`` (its round's loss sum over its L)
    from one device-to-host copy of the window's loss sums: the driver's
    wait for the device, which also waits for the comm steps queued
    before it.  With ``group`` each pending loss is the round's ``(steps,
    c)`` member losses of the rank's members: one sum over the ranks of
    the window's, then each step's cohort mean, added from 0 in step
    order as the one-process round adds them."""
    if group is not None:
        mats = [loss for _, loss in pending]
        full = group.all_reduce(torch.cat(mats))
        totals, k = [], 0
        for m in mats:
            tot = torch.zeros((), dtype=torch.float32, device=full.device)
            for j in range(m.shape[0]):
                # a fresh (c,) tensor, as the one-process step stacks it
                tot = tot + full[k + j].clone().mean()
            k += m.shape[0]
            totals.append(tot)
        pending = [(row, tot) for (row, _), tot in zip(pending, totals)]
    sums = torch.stack([loss for _, loss in pending]).cpu().tolist()
    for (row, _), total in zip(pending, sums):
        row["loss"] = total / row["L"]


# --------------------------------------------------------------------------
# pipelined rounds under bounded staleness (DESIGN.md §14)
# --------------------------------------------------------------------------


def free_uniform_cohort(seed: int, n: int, c: int, rnd: int,
                        busy) -> np.ndarray:
    """Uniform sorted ``(c,)`` int32 cohort of round ``rnd`` over the
    clients not in ``busy`` (an ``(n,)`` bool mask): a pure function of
    ``(seed, rnd, busy)`` on a numpy stream of its own (the reference
    keys its draw on the round's threefry comm key)."""
    busy = np.asarray(busy, bool)
    free = np.flatnonzero(~busy)
    if free.size < c:
        raise ValueError(
            f"only {free.size} free clients for c={c} at round {rnd}: "
            f"staleness too deep for this fleet (need c*(tau+1) <= n)"
        )
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), _TAG_FREE, int(rnd)]))
    pick = rng.choice(free.size, size=c, replace=False)
    return np.sort(free[pick]).astype(np.int32)


def run_rounds_pipelined(
    state: tamuna_dp.DistTamunaState,
    *,
    round_fn,
    rounds: int,
    rng: np.random.Generator,
    generator: torch.Generator,
    p: float,
    staleness: int = 1,
    flush_every: int = 10,
    logger=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    max_L: Optional[int] = None,
    plan=None,
    faults=None,
    latency=None,
    policy: str = "wait_all",
    quorum: Optional[int] = None,
    max_retries: int = 3,
    backoff0: float = 1.0,
    deadline: Optional[float] = None,
    guard: Optional[bool] = None,
    guard_max_abs: Optional[float] = None,
    guard_mode: Optional[str] = None,
    resume: bool = False,
) -> Tuple[tamuna_dp.DistTamunaState, List[Dict[str, Any]]]:
    """Pipelined rounds under bounded staleness ``tau = staleness``
    (``rounds.run_rounds_pipelined``), in place on ``state``.

    Pipeline step ``u`` stages round ``u`` (``round_fn.stage``: the
    cohort's local steps) and then commits round ``u - tau``
    (``round_fn.commit``: scatter, faults and guard, comm step), so up to
    ``tau`` rounds are in flight.  ``rng`` draws the round lengths,
    ``generator`` each round's permutation or shift at its stage (in round
    order, so a committed round uses the one it would have had
    synchronously) and, through its seed, the cohorts; the batches come
    from the engine's ``pipe``.  ``tau = 0`` stages and commits back to
    back: with ``run_rounds``' arguments it is ``run_rounds`` bitwise, and
    under a ``FaultPlan`` it reuses its fault resolver (retries, backoff,
    resampling).

    The schedule: round ``g``'s cohort excludes the clients of the ``tau``
    uncommitted rounds (``plan.cohort_excluding``, else
    ``free_uniform_cohort``; needs ``c (tau + 1) <= n`` and the elastic
    engine); the commit of ``g`` sends the DownCom to the cohort of ``g +
    tau + 1``.  At ``tau >= 1`` a member's uplink lands at ``dispatch_g +
    delay_i(g) L_g`` (``latency.delays`` or the ``FaultPlan``'s); the
    cutoff is the slowest member under ``wait_all``, the q-th finite
    arrival under ``quorum`` (ties admitted) and ``dispatch + deadline``
    under ``deadline``; late members are dropped from the survivor
    rebuild, and a quorum miss never resamples.  The simulated clock (never
    slept) runs ``dispatch_u = max(commit_{u-tau-1}, dispatch_{u-1})`` and
    ``commit_g = max(commit_{g-1}, cutoff_g)``.

    Returns the state and one row per committed round, logged every
    ``flush_every`` commits: ``run_rounds``' keys (``seconds`` is the host
    time from the previous commit's end to this one's, device
    synchronised) plus ``staleness``, ``dispatch_s``, ``commit_s``,
    ``round_latency_s``, ``admitted``, ``late_dropped`` and, on faulted
    commits, ``arrivals``, ``corrupted``, ``retries``, ``backoff_s``,
    ``quorum_miss`` and (when the engine traces coverage) ``uncovered``.
    The last row's ``commit_s`` is the run's simulated seconds.

    ``checkpoint_every`` saves ``pipeline_checkpoint_save`` at drain
    boundaries while ``tau`` rounds are in flight; ``resume=True`` restores
    the newest one into ``state`` (pass fresh streams and the run's total
    ``rounds``) and continues bitwise.  AdamW's shared count is scattered
    back last-wins, as in the reference."""
    engine = round_fn
    if not (hasattr(engine, "stage") and hasattr(engine, "commit")):
        raise ValueError("run_rounds_pipelined needs the split-phase "
                         "engine from make_pipelined_round_fn")
    if getattr(engine, "group", None) is not None:
        raise ValueError("the pipelined driver over ranks is not ported "
                         "(ROADMAP A9d); run_rounds takes a group")
    tau = int(staleness)
    if tau < 0:
        raise ValueError(f"staleness must be >= 0, got {tau}")
    n, c = engine.n, engine.c
    engine_cap = engine.max_L
    max_L = min(max_L or engine_cap, engine_cap)
    flush_every = max(1, min(flush_every, rounds))
    _check_policy(policy)
    if policy == "deadline" and deadline is None:
        raise ValueError("deadline policy needs a deadline (seconds)")
    if tau >= 1:
        if not engine.elastic:
            raise ValueError(
                "pipelining (staleness >= 1) needs the elastic engine: "
                "all-rows rounds touch every client row, so in-flight "
                "rounds cannot be disjoint"
            )
        if c * (tau + 1) > n:
            raise ValueError(
                f"staleness {tau} needs c*(tau+1) <= n "
                f"(got c={c}, n={n}): in-flight cohorts must be disjoint"
            )
    guard, guard_mode, adversarial = _resolve_guard(
        faults, guard, guard_max_abs, guard_mode)
    byz = faults.byzantine if adversarial else None
    if faults is not None and faults.n != n:
        raise ValueError(f"fault plan covers {faults.n} clients, "
                         f"engine has n={n}")
    if policy != "wait_all" and faults is None and (tau == 0
                                                    or latency is None):
        raise ValueError("round policies need a fault plan "
                         "(or, at staleness >= 1, a latency model)")
    lat_n = getattr(latency, "n", None)
    if lat_n is not None and lat_n != n:
        raise ValueError(f"latency model covers {lat_n} clients, "
                         f"engine has n={n}")
    if resume and not checkpoint_dir:
        raise ValueError("resume=True needs a checkpoint_dir")

    robust = (faults is not None and (
        not faults.is_zero or policy != "wait_all" or bool(guard)
    )) or (tau >= 1 and policy != "wait_all")
    sync_equiv = tau == 0 and robust  # the synchronous resolver
    q = quorum if quorum is not None else c // 2 + 1
    model = faults.model if faults is not None else None
    dev = state.x.device
    r0 = state.round
    seed = generator.initial_seed()
    host_cohort = _host_cohort(plan, seed, n, c)

    resolve = (_make_fault_resolver(
        faults, n=n, policy=policy, q=q, max_retries=max_retries,
        backoff0=backoff0, deadline=deadline, host_cohort=host_cohort,
    ) if sync_equiv else None)

    cohorts: Dict[int, np.ndarray] = {}

    def resolve_cohort(g: int, busy: np.ndarray) -> np.ndarray:
        got = cohorts.get(g)
        if got is not None:
            return got
        if plan is not None:
            co = np.asarray(plan.cohort_excluding(g, busy) if tau >= 1
                            else plan.cohort(g))
        elif not busy.any():
            co = uniform_cohort(seed, n, c, g)
        else:
            co = free_uniform_cohort(seed, n, c, g, busy)
        cohorts[g] = co
        return co

    def busy_mask() -> np.ndarray:
        busy = np.zeros(n, bool)
        for e in pend:
            busy[e["cohort"]] = True
        return busy

    lat_src = latency if latency is not None else faults

    def arr_offsets(g: int, steps: int, attempt: int = 0) -> np.ndarray:
        """(n,) arrival offsets: per-step latency draws times the round's
        local steps."""
        if lat_src is None:
            return np.zeros(n)
        return (np.asarray(lat_src.delays(g, attempt), np.float64)
                * max(int(steps), 1))

    pend: list = []  # in-flight staged rounds, oldest first
    window: list = []  # committed rounds awaiting the drain
    rows: List[Dict[str, Any]] = []
    dispatch: Dict[int, float] = {}
    committime: Dict[int, float] = {}
    total_steps = 0
    u0 = 0

    if resume:
        step = pipeline_latest_step(checkpoint_dir)
        if step is not None:
            blob = pipeline_checkpoint_restore(
                os.path.join(checkpoint_dir, f"pipe_step_{step}"),
                state=state, engine=engine, generator=generator)
            for e in blob["pending"]:
                cohorts[r0 + e["r"]] = e["cohort"]
                dispatch[e["r"]] = e["dispatch"]
                pend.append(e)
            u0 = step + len(pend)
            committime[step - 1] = blob["clock"]["last_commit"]
            if not pend:
                dispatch[u0 - 1] = blob["clock"]["last_dispatch"]
            total_steps = blob["clock"]["total_steps"]
            # replay (and discard) the L draws of the staged rounds
            for _ in range(u0):
                tamuna_dp.sample_round_length(rng, p, max_L=max_L)

    t_last = time.perf_counter()
    for u in range(u0, rounds + tau):
        if u < rounds:
            # ---- stage round u
            L = tamuna_dp.sample_round_length(rng, p, max_L=max_L)
            tmpl = engine.template(generator)
            g = r0 + u
            if sync_equiv:
                co = np.asarray(resolve(g)["cohort"])
            elif engine.elastic:
                co = resolve_cohort(g, busy_mask())
            else:
                # the all-rows body still takes a cohort for the template
                co = host_cohort(g)
            buf = engine.stage(state, L, co)
            d = max(committime.get(u - tau - 1, 0.0),
                    dispatch.get(u - 1, 0.0))
            dispatch[u] = d
            pend.append({"r": u, "cohort": co, "buf": buf, "dispatch": d,
                         "tmpl": tmpl})
        rc = u - tau
        if not (0 <= rc < rounds):
            continue
        # ---- commit round rc
        ent = pend.pop(0)
        g = r0 + rc
        co, buf = ent["cohort"], ent["buf"]
        if not engine.elastic:
            down = None
        elif sync_equiv:
            down = resolve(g + 1)["member"]
        else:
            down = np.zeros(n, bool)
            down[resolve_cohort(g + tau + 1, busy_mask())] = True
        kw: Dict[str, Any] = {}
        meta: Dict[str, Any] = {"staleness": tau}
        attempt = 0
        member = np.zeros(n, bool)
        member[co] = True
        if sync_equiv:
            res = resolve(g)
            attempt = res["retries"]
            arr = ent["dispatch"] + arr_offsets(g, buf["steps"], attempt)
            cutoff = (float(arr[res["arrived"]].max())
                      if res["arrived"].any() else ent["dispatch"])
            cutoff += res["backoff"]
            kw = dict(arrived=res["arrived"],
                      corrupt=(res["corrupt"]
                               if faults.model.p_corrupt > 0 else None),
                      correct=policy != "wait_all")
            meta.update(
                retries=res["retries"], backoff_s=res["backoff"],
                quorum_miss=res["quorum_miss"],
                admitted=int(res["arrived"].sum()), late_dropped=0,
            )
        elif robust:
            dropped = (faults.drops(g, 0) if faults is not None
                       else np.zeros(n, bool))
            finite = member & ~dropped
            arr = np.where(finite,
                           ent["dispatch"] + arr_offsets(g, buf["steps"]),
                           np.inf)
            if policy == "wait_all":
                cutoff = (float(arr[finite].max()) if finite.any()
                          else ent["dispatch"])
                admitted = finite
            elif policy == "quorum":
                kq = min(q, int(finite.sum()))
                if kq == 0:
                    cutoff, admitted = ent["dispatch"], np.zeros(n, bool)
                else:
                    cutoff = float(np.sort(arr[finite])[kq - 1])
                    admitted = finite & (arr <= cutoff)
            else:
                # deadline cuts on the simulated arrival time here (the
                # synchronous driver cuts on the raw per-round draw)
                cutoff = ent["dispatch"] + float(deadline)
                admitted = finite & (arr <= cutoff)
            kw = dict(arrived=admitted,
                      corrupt=(faults.corrupts(g, 0) & member
                               if faults is not None
                               and faults.model.p_corrupt > 0 else None),
                      correct=policy != "wait_all")
            meta.update(
                retries=0, backoff_s=0.0,
                quorum_miss=int(policy == "quorum"
                                and int(finite.sum()) < q),
                admitted=int(admitted.sum()),
                late_dropped=int((finite & ~admitted).sum()),
            )
        else:
            # everyone arrives: the clock still waits for the slowest
            # member, the wait_all barrier (every row, as the reference's
            # all-rows body without a plan)
            off = arr_offsets(g, buf["steps"])
            if engine.elastic or plan is not None:
                cutoff = ent["dispatch"] + float(off[member].max())
                meta.update(admitted=int(member.sum()), late_dropped=0)
            else:
                cutoff = ent["dispatch"] + float(off.max())
                meta.update(admitted=n, late_dropped=0)
        if kw:
            kw.update(byz=byz, model=model, guard=bool(guard),
                      guard_mode=guard_mode, guard_max_abs=guard_max_abs)
        tc = max(committime.get(rc - 1, 0.0), cutoff)
        committime[rc] = tc
        wseed = wire_seed(seed, g, attempt) if engine.on_wire else None
        state, info = engine.commit(state, buf, co, down, **ent["tmpl"],
                                    wire_seed=wseed, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_now = time.perf_counter()
        meta.update(dispatch_s=ent["dispatch"], commit_s=tc,
                    round_latency_s=tc - ent["dispatch"])
        window.append({
            "round": g, "meta": meta, "info": info, "loss": buf["loss"],
            "steps": buf["steps"], "seconds": t_now - t_last,
            "counters": (state.up_floats, state.down_floats,
                         state.up_bytes, state.down_bytes),
        })
        t_last = t_now
        drained = False
        if len(window) == flush_every or rc == rounds - 1:
            for w in window:
                total_steps += w["steps"]
                up, down_f, upb, downb = w["counters"]
                row = {
                    "round": w["round"], "L": w["steps"],
                    "loss": float(w["loss"]) / max(w["steps"], 1),
                    "local_steps": total_steps,
                    "up_floats": float(up), "down_floats": float(down_f),
                    "up_bytes": float(upb), "down_bytes": float(downb),
                    "seconds": w["seconds"],
                }
                if robust:
                    row["arrivals"] = int(w["info"]["arrived"].sum())
                    row["corrupted"] = int(w["info"]["bad"].sum())
                    if "uncovered" in w["info"]:
                        row["uncovered"] = int(w["info"]["uncovered"])
                row.update(w["meta"])
                rows.append(row)
                if logger is not None:
                    logger.log(w["round"], row)
            window = []
            drained = True
        if (drained and checkpoint_dir and checkpoint_every
                and (rc + 1) % checkpoint_every == 0
                and len(pend) == tau and rc + 1 < rounds):
            pipeline_checkpoint_save(
                os.path.join(checkpoint_dir, f"pipe_step_{rc + 1}"),
                state, pend,
                {"last_dispatch": dispatch.get(u, 0.0), "last_commit": tc,
                 "total_steps": total_steps},
                rc + 1, engine=engine, generator=generator)
    return state, rows


class PipeCarry(NamedTuple):
    """What a pipe checkpoint keeps beside the pending rounds: the state
    (the reference's ``RoundCarry.state``) and the positions of the port's
    two streams, the pipe's batch generator and the permutation/shift
    generator (where the reference keeps ``data_key``/``comm_key``)."""

    state: Any
    data_generator: Any
    comm_generator: Any


def _rows_tree(state, rows: Sequence[int], count) -> Any:
    """The workspace rows ``rows`` as the reference's compact
    ``DistTamunaState`` tree (``checkpoint.state_tree`` of the rows),
    copied to the host now; ``count`` is the rows' AdamW count."""
    from repro_torch import checkpoint
    from repro_torch.optim import optimizers

    def take(ws):
        return torch.stack([ws[int(i)].cpu() for i in rows])

    opt = state.opt
    if isinstance(opt, optimizers.AdamState):
        opt = optimizers.AdamState(take(opt.mu), take(opt.nu), count)
    return checkpoint.state_tree(dataclasses.replace(
        state, x=take(state.x), h=take(state.h), opt=opt))


def pipeline_checkpoint_save(path: str, state, pending, clock: Dict,
                             step: int, *, engine, generator) -> None:
    """Checkpoint a pipelined run mid-flight under ``pipe_step_<k>`` (``k``
    committed rounds; ``checkpoint.latest_step`` does not see it), one
    ``checkpoint.save`` tree: ``carry`` (``PipeCarry``: the state and the
    two generators' states), ``pending/<i>`` per in-flight round (its rows
    as a compact state copied now, its loss, steps, index ``r``, cohort,
    dispatch time and ``template``, the permutation or ``[off]``) and
    ``clock`` (``last_dispatch``, ``last_commit`` in float64,
    ``total_steps``)."""
    from repro_torch import checkpoint

    pend = tuple(
        {
            "compact": _rows_tree(state, e["cohort"],
                                  e["buf"]["compact"].count),
            "loss": np.float32(float(e["buf"]["loss"])),
            "steps": np.int32(e["buf"]["steps"]),
            "r": np.int32(e["r"]),
            "cohort": np.asarray(e["cohort"], np.int32),
            "dispatch": np.float64(e["dispatch"]),
            "template": np.asarray(
                e["tmpl"]["perm"] if e["tmpl"]["off"] is None
                else [e["tmpl"]["off"]], np.int32),
        }
        for e in pending
    )
    carry = PipeCarry(checkpoint.state_tree(state),
                      engine.pipe.generator.get_state(),
                      generator.get_state())
    checkpoint.save(path, {
        "carry": carry, "pending": pend,
        "clock": {"last_dispatch": np.float64(clock["last_dispatch"]),
                  "last_commit": np.float64(clock["last_commit"]),
                  "total_steps": np.int32(clock["total_steps"])},
    }, step)


def pipeline_checkpoint_restore(path: str, *, state, engine,
                                generator) -> Dict[str, Any]:
    """Restore a pipe checkpoint by leaf name: the state in place, each
    pending round's compact rows written into its cohort's workspace rows
    (the reference's checkpoint holds the state from before their local
    steps), and, when the checkpoint has them (the port's), the two
    generators' positions and each round's template; without, the
    templates are drawn from ``generator`` in pending order.  Returns
    ``{"pending": [entries as the driver keeps them], "clock": {...}}``.
    The number of pending rounds is read from the leaf names."""
    from repro_torch import checkpoint

    named = checkpoint.load_named(path)
    checkpoint.fill_state(state, named, prefix="carry/.state/")
    for key, gen in (("carry/.data_generator", engine.pipe.generator),
                     ("carry/.comm_generator", generator)):
        if key in named:
            gen.set_state(torch.from_numpy(named[key][0].copy()))
    idx = sorted({int(nm.split("/")[1]) for nm in named
                  if nm.startswith("pending/")})
    pending = []
    for i in idx:
        pre = f"pending/{i}/"
        co = np.asarray(named[pre + "cohort"][0], np.int32)
        # the compact rows go back into the workspace rows, then the
        # buffer takes views of them as a stage does
        compact = tamuna_dp.gather_cohort(state, co)
        count = checkpoint.fill_rows(state, named, co,
                                     prefix=pre + "compact/")
        if count is not None:
            compact.count = count
        if pre + "template" in named:
            tv = named[pre + "template"][0].astype(np.int64).tolist()
            tmpl = ({"perm": None, "off": tv[0]} if engine.blocked
                    else {"perm": tv, "off": None})
        else:
            tmpl = engine.template(generator)
        loss = torch.tensor(float(np.float32(named[pre + "loss"][0])),
                            dtype=torch.float32, device=state.x.device)
        pending.append({
            "r": int(named[pre + "r"][0]), "cohort": co,
            "dispatch": float(named[pre + "dispatch"][0]), "tmpl": tmpl,
            "buf": {"compact": compact, "loss": loss,
                    "steps": int(named[pre + "steps"][0])},
        })
    clock = {k: named["clock/" + k][0]
             for k in ("last_dispatch", "last_commit", "total_steps")}
    return {"pending": pending, "clock": {
        "last_dispatch": float(clock["last_dispatch"]),
        "last_commit": float(clock["last_commit"]),
        "total_steps": int(clock["total_steps"])}}


def pipeline_latest_step(root: str) -> Optional[int]:
    """The newest ``pipe_step_<k>`` under ``root`` (``k`` committed
    rounds), or None."""
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("pipe_step_")]
    return max(steps) if steps else None
