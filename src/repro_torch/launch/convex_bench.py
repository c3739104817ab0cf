"""The convex round-count benches of the reference, on the port.

Three of the reference's results run the strongly convex logistic
regression (Theorem-3 tuned TAMUNA) through the plain comm step
``comm_ws.cyclic_comm(impl="ws")``, which the port has as
``repro_torch.dist.comm_ws.cyclic_comm_leaves``:

``faults``  ``benchmarks/faults_bench.py``: Bernoulli uplink dropout
            ``p_fail`` in {0, 0.1, 0.2, 0.4} under three drivers (fault
            free; ``quorum``: the survivor rebuild, a cohort resample with
            capped exponential backoff below ``C//2 + 1`` arrivals;
            ``wait_all``: the biased ``1/s`` control), rounds to 1e-3 of
            the initial gap, and a bitwise replay of the ``p_fail = 0.2``
            quorum run;
``quant``   the convergence half of ``benchmarks/quant_comm_bench.py``:
            the wire at f32, f16, int8 and int4 for the rounds the f32 wire
            needs to reach the target, and each width's floor (the least
            suboptimality over the last rounds);
``robust``  ``benchmarks/robust_bench.py``: a persistent Byzantine
            quarter of the fleet (``sign_flip``, and ``scale`` by 1e8 as
            ``blowup``) against the mean (nonfinite guard only) and the
            trimmed mean (k = c/3) and median behind the adaptive guard,
            the anomaly reputation and ``recenter_h``, at ``s = c = 3N/4``;
            rounds to 1e-3 of the squared distance to the honest clients'
            optimum, a bitwise replay, the identity contract (``trimmed``
            k=0 is the mean in ws, dense and the kernel path), the robust
            comm step's cost over the mean's at ``(N, 65536)``, and the
            int8 wire under the trimmed mean.

The constants, seeds and draws are the reference's: N 16 clients, D 32,
8 samples each, kappa 100, C = N // 4, at most 4000 rounds;
``CohortPlan(seed=7)``, ``FaultPlan(seed=3)``, permutations from
``SeedSequence([7, 97, g, attempt])`` (``[7, 97, g]`` in the robust
bench), and the quant bench's cohorts and permutations from
``default_rng(3)``.  ``--smoke`` is the reference's ``REPRO_BENCH_SMOKE=1``
size.  The reference draws the wire seeds from threefry; here they come
from the port's own stream (``rounds.wire_seed``) unless ``wire_seeds``
are passed in.

The counts are machine-independent: the reference's ``BENCH_faults.json``
and ``BENCH_quant_comm.json`` hold the targets.  This driver writes its own
JSON (``--out``, by default ``chiprun_out/convex_bench.json``) and never a
``BENCH_*.json``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.convex_bench --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.convex_bench --only robust \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_OUT = os.path.join(REPO, "chiprun_out", "convex_bench.json")

# the reference benches' sizes: (full, smoke)
SIZES = {
    False: dict(n=16, d=32, spc=8, kappa=100.0, target_rel=1e-3,
                faults_rounds=4000, quant_rounds=4000,
                p_fails=(0.0, 0.1, 0.2, 0.4),
                kinds=("f32", "f16", "int8", "int4"), tail=20,
                robust_rounds=4000, time_d=65536, time_iters=30),
    True: dict(n=8, d=16, spc=4, kappa=50.0, target_rel=1e-1,
               faults_rounds=80, quant_rounds=60, p_fails=(0.0, 0.2),
               kinds=("f32", "int8"), tail=5,
               robust_rounds=80, time_d=4096, time_iters=10),
}
MAX_RETRIES, BACKOFF0 = 3, 1.0
BITS = {"f32": 32, "f16": 16, "int8": 8, "int4": 4}


class ConvexBench:
    """A convex problem's TAMUNA rounds with the plain comm step: the
    Theorem-3 tuned config at cohort ``c``, ``L = round(1/p)`` local
    steps, and the bench's ``size`` (``SIZES``; None outside a bench)."""

    def __init__(self, prob, c: int, size: Optional[dict] = None,
                 s: Optional[int] = None):
        from repro_torch.core import tamuna

        self.prob, self.size = prob, size
        self.device = prob.device
        self.n, self.d, self.c = prob.n, prob.d, c
        self.cfg = (tamuna.TamunaConfig.tuned(prob, c=c) if s is None
                    else tamuna.TamunaConfig.tuned(prob, c=c, s=s))
        self.L = max(1, round(1.0 / self.cfg.p))
        self.scale = self.cfg.eta / self.cfg.gamma
        self.gap0 = self.suboptimality(torch.zeros(
            self.d, dtype=torch.float64, device=self.device))
        self.target = (None if size is None
                       else self.gap0 * size["target_rel"])

    @classmethod
    def for_bench(cls, smoke: bool, device) -> "ConvexBench":
        """The reference benches' problem (``SIZES``) on ``device``, at
        the faults and quant benches' cohort ``N // 4``."""
        from repro_torch.core import problems

        z = SIZES[bool(smoke)]
        prob = problems.make_logreg_problem(
            n=z["n"], d=z["d"], samples_per_client=z["spc"],
            kappa=z["kappa"], seed=0, device=resolve_device(device))
        return cls(prob, max(2, z["n"] // 4), z)

    def robust_variant(self) -> "ConvexBench":
        """The same problem at the robust bench's cohort ``c = max(4,
        3N/4)`` and redundancy ``s = c``."""
        c = max(4, (3 * self.n) // 4)
        return ConvexBench(self.prob, c, self.size, s=c)

    def suboptimality(self, x: torch.Tensor) -> float:
        return float(self.prob.suboptimality(x))

    def local_steps(self, x_bar, h, cohort):
        """The cohort's ``L`` local steps from ``x_bar``: ``X - gamma
        grad_i(X) + gamma h_i``, in float64."""
        data = self.prob.cohort_data(cohort)
        hc = h[cohort]
        X = x_bar.expand(self.c, self.d)
        g = self.cfg.gamma
        for _ in range(self.L):
            X = X - g * self.prob.grads(X, data) + g * hc
        return X

    def comm(self, x_bar, h, Xc, cohort, slot, **kw):
        """The comm step over the population: the rows outside the cohort
        sit at ``x_bar``; returns the new ``(x, h)``."""
        from repro_torch.dist import comm_ws

        X = x_bar.expand(self.n, self.d).clone()
        X[cohort] = Xc
        return comm_ws.cyclic_comm_leaves(X, h, slot, self.c, self.cfg.s,
                                          self.scale, impl="ws", **kw)

    def server_model(self, x_new, cohort: np.ndarray) -> torch.Tensor:
        """The server model read off the first idle row: covered
        coordinates carry the aggregate, uncovered ones kept ``x_bar``."""
        idle = int(np.setdiff1d(np.arange(self.n), cohort)[0])
        return x_new[idle]

    def slot_of(self, cohort: np.ndarray, perm: np.ndarray) -> torch.Tensor:
        slot = np.full(self.n, -1, np.int64)
        slot[cohort] = perm
        return torch.from_numpy(slot).to(self.device)

    def config(self) -> dict:
        z = self.size
        return {"n": self.n, "d": self.d, "c": self.c, "s": self.cfg.s,
                "L": self.L, "kappa": z["kappa"],
                "target_rel": z["target_rel"]}


def resolve_round(plan, faults, g: int, quorum: int):
    """Round ``g``'s cohort under ``faults``: with ``quorum`` > 0 a cohort
    whose arrivals fall below it is resampled (a fresh attempt, up to
    ``MAX_RETRIES``) after a capped exponential backoff.  Returns
    ``(cohort, arrived (n,) bool, attempt, backoff)``."""
    attempt, backoff = 0, 0.0
    while True:
        cohort = np.asarray(plan.cohort(g, attempt))
        member = np.zeros(plan.n, bool)
        member[cohort] = True
        arrived = member & ~faults.drops(g, attempt)
        if int(arrived.sum()) < quorum and attempt < MAX_RETRIES:
            backoff += BACKOFF0 * (2.0 ** attempt)
            attempt += 1
            continue
        return cohort, arrived, attempt, backoff


def round_permutation(g: int, attempt: int, c: int) -> np.ndarray:
    """A fresh ownership permutation per round and attempt (Algorithm 1
    line 10), from ``SeedSequence([7, 97, g, attempt])``."""
    return np.random.default_rng(
        np.random.SeedSequence([7, 97, g, attempt])).permutation(c)


def run_fault_driver(bench: ConvexBench, p_fail: float, policy: str,
                     seed: int = 3) -> dict:
    """One driver of ``faults_bench.py``'s ``run_driver``: rounds until
    the suboptimality falls below the target (or the round cap)."""
    from repro_torch.dist.cohort import CohortPlan
    from repro_torch.dist.faults import FaultModel, FaultPlan

    n, dev = bench.n, bench.device
    faults = FaultPlan(seed=seed, n=n, model=FaultModel(p_drop=p_fail))
    plan = CohortPlan(seed=7, n=n, c=bench.c)
    faulted = p_fail > 0.0
    q = bench.c // 2 + 1
    x_bar = torch.zeros(bench.d, dtype=torch.float64, device=dev)
    h = torch.zeros(n, bench.d, dtype=torch.float64, device=dev)
    retries = quorum_miss = 0
    clock = 0.0
    hit = None
    subs = []
    for g in range(bench.size["faults_rounds"]):
        cohort, arrived, attempt, backoff = resolve_round(
            plan, faults, g, q if policy == "quorum" else 0)
        quorum_miss += attempt
        retries += attempt
        clock += float(bench.L) + backoff
        perm = round_permutation(g, attempt, bench.c)
        cohort_t = torch.from_numpy(cohort.astype(np.int64)).to(dev)
        Xc = bench.local_steps(x_bar, h, cohort_t)
        kw = {}
        if faulted:
            kw = dict(arrived=torch.from_numpy(arrived).to(dev),
                      correct=policy == "quorum")
        x_new, h = bench.comm(x_bar, h, Xc, cohort_t,
                              bench.slot_of(cohort, perm), **kw)
        x_bar = bench.server_model(x_new, cohort)
        subs.append(bench.suboptimality(x_bar))
        if subs[-1] < bench.target:
            hit = g + 1
            break
    return {
        "p_fail": p_fail, "policy": policy,
        "rounds_to_target": hit, "final_suboptimality": subs[-1],
        "retries": retries, "quorum_miss": quorum_miss,
        "sim_clock": clock,
        "x_fingerprint": [float(v) for v in x_bar[:4].tolist()],
    }


def run_faults(bench: ConvexBench) -> dict:
    """``faults_bench.py``'s sweep, acceptance and replay."""
    rows = [run_fault_driver(bench, 0.0, "fault_free")]
    base = rows[0]["rounds_to_target"]
    p_fails = bench.size["p_fails"]
    for pf in p_fails:
        if pf == 0.0:
            continue
        for policy in ("quorum", "wait_all"):
            rows.append(run_fault_driver(bench, pf, policy))
    # deterministic replay: the same seeds give the same trajectory
    pf_chk = 0.2 if 0.2 in p_fails else max(p_fails)
    a = run_fault_driver(bench, pf_chk, "quorum")
    b = run_fault_driver(bench, pf_chk, "quorum")
    replay_ok = (a["rounds_to_target"] == b["rounds_to_target"]
                 and a["x_fingerprint"] == b["x_fingerprint"])
    by = {(r["p_fail"], r["policy"]): r for r in rows}
    q02, w02 = by.get((0.2, "quorum")), by.get((0.2, "wait_all"))
    ratio = (q02["rounds_to_target"] / base
             if q02 and q02["rounds_to_target"] and base else None)
    control_fails = (w02 is not None and (
        w02["rounds_to_target"] is None
        or w02["final_suboptimality"] >= 10 * bench.target))
    return {
        "rows": rows,
        "target": bench.target,
        "fault_free_rounds": base,
        "quorum_ratio_at_p02": ratio,
        "wait_all_control_stalls_at_p02": control_fails,
        "deterministic_replay_ok": replay_ok,
        "acceptance": {"quorum_ratio_max": 2.0,
                       "control_must_stall_or_bias": True,
                       "replay_bitwise": True},
        "config": {**bench.config(), "quorum": bench.c // 2 + 1,
                   "max_rounds": bench.size["faults_rounds"],
                   "p_fails": list(p_fails), "max_retries": MAX_RETRIES,
                   "backoff0": BACKOFF0},
    }


def run_kind(bench: ConvexBench, kind: str, rounds: int,
             wire_seeds: Sequence[int], seed: int = 3) -> dict:
    """One width of ``quant_comm_bench.py``'s ``run_kind``: ``rounds``
    rounds (the f32 wire stops at the target)."""
    from repro_torch.dist import wire

    dev = bench.device
    wired = wire.is_wire(kind)
    rng = np.random.default_rng(seed)
    x_bar = torch.zeros(bench.d, dtype=torch.float64, device=dev)
    h = torch.zeros(bench.n, bench.d, dtype=torch.float64, device=dev)
    subs = []
    hit = None
    for g in range(rounds):
        cohort = rng.choice(bench.n, size=bench.c, replace=False)
        perm = rng.permutation(bench.c)
        cohort_t = torch.from_numpy(cohort.astype(np.int64)).to(dev)
        Xc = bench.local_steps(x_bar, h, cohort_t)
        kw = (dict(wire=kind, wire_seed=int(wire_seeds[g])) if wired
              else {})
        x_new, h = bench.comm(x_bar, h, Xc, cohort_t,
                              bench.slot_of(cohort, perm), **kw)
        x_bar = bench.server_model(x_new, cohort)
        subs.append(bench.suboptimality(x_bar))
        if hit is None and subs[-1] < bench.target:
            hit = g + 1
            if kind == "f32":
                break
    floor = float(np.min(subs[-bench.size["tail"]:]))
    return {"kind": kind, "bits": BITS[kind], "rounds": len(subs),
            "rounds_to_target": hit, "final_suboptimality": subs[-1],
            "floor": floor}


def port_wire_seeds(rounds: int, seed: int = 3) -> list:
    """The port's per-round wire seeds of the quant bench."""
    from repro_torch.dist.rounds import wire_seed

    return [wire_seed(seed, g) for g in range(rounds)]


def run_quant(bench: ConvexBench,
              wire_seeds: Optional[Sequence[int]] = None) -> dict:
    """The convergence half of ``quant_comm_bench.py``: every width runs
    the rounds ``R`` the f32 wire needs to reach the target.
    ``wire_seeds[g]`` is round ``g``'s uint32 wire seed (default: the
    port's own stream)."""
    z = bench.size
    if wire_seeds is None:
        wire_seeds = port_wire_seeds(z["quant_rounds"])
    f32_probe = run_kind(bench, "f32", z["quant_rounds"], wire_seeds)
    R = f32_probe["rounds_to_target"] or z["quant_rounds"]
    rows = [run_kind(bench, k, R, wire_seeds) for k in z["kinds"]]
    by = {r["kind"]: r for r in rows}
    return {
        "rows": rows,
        "matched_rounds": R,
        "target": bench.target,
        "initial_gap": bench.gap0,
        "floor_ratio_int8_vs_f32": by["int8"]["floor"] / by["f32"]["floor"],
        "acceptance": {"floor_ratio_max": 10.0},
        "config": {**bench.config(), "kinds": list(z["kinds"]),
                   "tail": z["tail"]},
    }


# --------------------------------------------------------------------------
# the robust bench (benchmarks/robust_bench.py)
# --------------------------------------------------------------------------

F_BYZ = 0.25


def solve_subset(prob, idx, iters: int = 20000) -> torch.Tensor:
    """The optimum of the mean objective of the clients ``idx``:
    ``iters`` full-gradient steps of ``1/L`` from 0, in float64."""
    idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                            device=prob.device)
    data = prob.cohort_data(idx_t)
    x = torch.zeros(prob.d, dtype=torch.float64, device=prob.device)
    step = 1.0 / prob.L
    for _ in range(iters):
        x = x - step * prob.grads(x.expand(len(idx), prob.d),
                                  data).mean(dim=0)
    return x


class RobustBench:
    """The robust bench's constants on a ``ConvexBench`` at ``s = c``:
    the trim depth ``c // 3``, the Byzantine set of ``FaultPlan(seed=3)``
    and the honest clients' optimum."""

    def __init__(self, bench: ConvexBench):
        from repro_torch.dist.faults import FaultModel, FaultPlan

        self.bench = bench
        self.trim_k = bench.c // 3
        self.byz = FaultPlan(seed=3, n=bench.n, model=FaultModel(
            adversary="sign_flip", f_byz=F_BYZ)).byzantine
        self.x_star_honest = solve_subset(bench.prob,
                                          np.flatnonzero(~self.byz))


def robust_permutation(g: int, c: int) -> np.ndarray:
    """Round ``g``'s ownership permutation of the robust bench, from
    ``SeedSequence([7, 97, g])``."""
    return np.random.default_rng(
        np.random.SeedSequence([7, 97, g])).permutation(c)


def run_robust_driver(rb: RobustBench, attack: str, agg: str) -> dict:
    """One driver of ``robust_bench.py``'s ``run_driver``: the attack
    (``none``, ``sign_flip`` or ``blowup``) against the aggregator (``mean``
    with the nonfinite guard; ``trimmed``/``median`` with the adaptive
    guard, the reputation and ``recenter_h``) until the relative squared
    distance to the reference optimum falls below the target."""
    from repro_torch.dist import faults, robust
    from repro_torch.dist.cohort import CohortPlan

    bench = rb.bench
    n, d, c, dev = bench.n, bench.d, bench.c, bench.device
    spec = robust.normalize_robust(
        agg, rb.trim_k if agg == "trimmed" else 0, bench.cfg.s)
    robust_run = attack != "none" and agg != "mean"
    guard = "adaptive" if robust_run else "nonfinite"
    byz = rb.byz if attack != "none" else np.zeros(n, bool)
    # attack rows chase the honest clients' optimum, the reachable floor
    x_ref = rb.x_star_honest if attack != "none" else bench.prob.x_star
    err0 = float(torch.sum(x_ref * x_ref))
    plan = CohortPlan(seed=7, n=n, c=c)
    rep = (robust.Reputation(n, threshold=3.0, base_rounds=16,
                             max_doublings=6) if robust_run else None)
    quarantined_ever = np.zeros(n, bool)
    x_bar = torch.zeros(d, dtype=torch.float64, device=dev)
    h = torch.zeros(n, d, dtype=torch.float64, device=dev)
    target = bench.size["target_rel"]
    hit, diverged, guarded = None, False, 0
    err = sub = float("nan")
    for g in range(bench.size["robust_rounds"]):
        cohort = np.asarray(plan.cohort(g))
        member = np.zeros(n, bool)
        member[cohort] = True
        cohort_t = torch.from_numpy(cohort.astype(np.int64)).to(dev)
        slot = bench.slot_of(cohort, robust_permutation(g, c))
        Xc = bench.local_steps(x_bar, h, cohort_t)
        X = x_bar.expand(n, d).clone()
        X[cohort_t] = Xc
        arrived = member.copy()
        bad = np.zeros(n, bool)
        if attack != "none" and (byz & member).any():
            if attack == "sign_flip":
                faults.adversarial_rows(X, byz & member, member & ~byz,
                                        "sign_flip")
            else:  # finite blowup: scale by 1e8
                faults.adversarial_rows(X, byz & member, member & ~byz,
                                        "scale", byz_scale=1e8)
            Xc = X[cohort_t]
            if guard == "adaptive":
                bad = robust.magnitude_outliers(X, arrived)
                guarded += int(bad.sum())
                arrived &= ~bad
        x_new, h = bench.comm(x_bar, h, Xc, cohort_t, slot,
                              arrived=torch.from_numpy(arrived).to(dev),
                              correct=True, robust=spec)
        if rep is not None:
            anom = robust.anomaly_scores(X, arrived)
            # a guard hit is hard evidence: scored above the threshold, so
            # guarded rows still accumulate strikes
            anom[bad] = 2.0 * rep.threshold
            for cid, w in rep.update(anom, arrived | bad):
                plan.quarantine([cid], g + 1, g + w)
                quarantined_ever[cid] = True
            h = robust.recenter_h(h, ~quarantined_ever)
        x_bar = bench.server_model(x_new, cohort)
        delta = x_bar - x_ref
        err = float(torch.sum(delta * delta)) / err0
        sub = bench.suboptimality(x_bar)
        if not math.isfinite(err):
            diverged = True
            break
        if err < target:
            hit = g + 1
            break
    qids = sorted({int(i) for ids, _, _ in plan._quarantine for i in ids})
    xb = x_bar.cpu()
    return {
        "attack": attack, "agg": agg,
        "f_byz": F_BYZ if attack != "none" else 0.0, "guard": guard,
        "rounds_to_target": hit, "final_err_rel": err,
        "final_suboptimality": sub,
        "diverged": diverged, "guarded_rows": guarded,
        "quarantine_windows": len(plan._quarantine),
        "quarantined_byz_only": (bool(all(byz[i] for i in qids))
                                 if qids else None),
        "x_fingerprint": ([float(v) for v in xb[:4].tolist()]
                          if bool(torch.isfinite(xb).all()) else None),
    }


def timer(device):
    """``timed(fn, iters)``: the best of 3 means of ``iters`` calls after
    one warm-up call, in microseconds; on the card each mean ends in a
    synchronisation."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, iters: int) -> float:
        fn()
        sync()
        best = float("inf")
        for _ in range(3):  # scheduler noise only ever adds time
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        return best

    return timed


def run_robust(bench: ConvexBench,
               wire_seed: Optional[int] = None) -> dict:
    """``robust_bench.py``'s rows, replay, overhead, identity contract and
    int8 interplay on ``bench``'s problem (at its ``robust_variant``).
    ``wire_seed`` is the int8 step's uint32 seed (default: the port's
    stream, ``rounds.wire_seed(5, 0)``; the reference draws it from
    threefry)."""
    from repro_torch.dist import comm_ws, robust
    from repro_torch.dist.rounds import wire_seed as port_wire_seed

    rb = RobustBench(bench.robust_variant())
    rbench = rb.bench
    n, c, S, dev = rbench.n, rbench.c, rbench.cfg.s, rbench.device
    z = rbench.size
    rows = [run_robust_driver(rb, "none", "mean")]
    base = rows[0]["rounds_to_target"]
    for attack in ("sign_flip", "blowup"):
        for agg in ("mean", "trimmed", "median"):
            rows.append(run_robust_driver(rb, attack, agg))
    # deterministic replay: the same seeds give the same trajectory
    a = run_robust_driver(rb, "sign_flip", "trimmed")
    b = run_robust_driver(rb, "sign_flip", "trimmed")
    replay_ok = (a["rounds_to_target"] == b["rounds_to_target"]
                 and a["x_fingerprint"] == b["x_fingerprint"])

    # the robust comm step's cost over the mean's (the ws impl the loop
    # uses), beside the kernel path's (robust_sum)
    rngt = np.random.default_rng(11)
    D = z["time_d"]
    Xt = torch.from_numpy(rngt.normal(size=(n, D)).astype(np.float32)).to(
        dev)
    ht = torch.from_numpy(rngt.normal(size=(n, D)).astype(np.float32)).to(
        dev)
    slot_np = np.full(n, -1, np.int64)
    coh = rngt.choice(n, size=c, replace=False)
    slot_np[coh] = rngt.permutation(c)
    slot_t = torch.from_numpy(slot_np).to(dev)
    timed = timer(dev)
    iters = z["time_iters"]

    def ws_step(spec, s, **kw):
        return comm_ws.cyclic_comm_leaves(Xt, ht, slot_t, c, s, 0.37,
                                          impl="ws", robust=spec, **kw)

    s_prod = min(4, c)
    t_mean = timed(lambda: ws_step(None, s_prod), iters)
    t_trim = timed(lambda: ws_step(("trimmed", 1), s_prod), iters)
    t_med = timed(lambda: ws_step(("median", 0), s_prod), iters)
    t_mean_sc = timed(lambda: ws_step(None, S), iters)
    t_rob_sc = max(timed(lambda: ws_step(("trimmed", rb.trim_k), S), iters),
                   timed(lambda: ws_step(("median", 0), S), iters))
    slot32 = slot_t.to(torch.int32)
    band = comm_ws.cyclic_band([D], c, s_prod, dev)
    xw, hw = Xt.clone(), ht.clone()  # the kernel path works in place

    def kernel_step(spec):
        return comm_ws.cyclic_comm(xw, hw, slot32, band, c, s_prod, 0.37,
                                   robust=spec)

    k_mean = timed(lambda: kernel_step(None), iters)
    k_trim = timed(lambda: kernel_step(("trimmed", 1)), iters)
    k_med = timed(lambda: kernel_step(("median", 0)), iters)
    del xw, hw

    # identity contract: trimmed k=0 normalizes to the mean, bitwise in
    # dense, ws and the kernel path
    spec0 = robust.normalize_robust("trimmed", 0, S)
    identity_ok = spec0 is None
    for impl in ("dense", "ws"):
        (xa, ha), (xb, hb) = (comm_ws.cyclic_comm_leaves(
            Xt, ht, slot_t, c, S, 0.37, impl=impl, robust=sp)
            for sp in (None, spec0))
        identity_ok &= bool(torch.equal(xa, xb) and torch.equal(ha, hb))
    band_s = comm_ws.cyclic_band([D], c, S, dev)
    outs = []
    for sp in (None, spec0):
        xk, hk = Xt.clone(), ht.clone()
        comm_ws.cyclic_comm(xk, hk, slot32, band_s, c, S, 0.37, robust=sp)
        outs.append((xk, hk))
    identity_ok &= bool(torch.equal(outs[0][0], outs[1][0])
                        and torch.equal(outs[0][1], outs[1][1]))

    # int8 wire interplay: robust stats on the dequantized values stay at
    # quantization scale of the f32-wire robust aggregate
    seed_w = port_wire_seed(5, 0) if wire_seed is None else int(wire_seed)
    xw8, _ = ws_step(("trimmed", rb.trim_k), S, wire="int8",
                     wire_seed=seed_w)
    xf, _ = ws_step(("trimmed", rb.trim_k), S)
    wire_dev = float((xw8 - xf).abs().max())

    by = {(r["attack"], r["agg"]): r for r in rows}
    target = z["target_rel"]

    def ratio(attack, agg):
        r = by[(attack, agg)]["rounds_to_target"]
        return (r / base) if (r and base) else None

    def control_stalls(attack):
        r = by[(attack, "mean")]
        return (r["diverged"] or r["rounds_to_target"] is None
                or not math.isfinite(r["final_err_rel"])
                or r["final_err_rel"] >= 10 * target)

    return {
        "rows": rows,
        "target_rel": target,
        "fault_free_rounds": base,
        "ratios": {f"{a}/{g}": ratio(a, g)
                   for a in ("sign_flip", "blowup")
                   for g in ("trimmed", "median")},
        "mean_control_stalls": {a: control_stalls(a)
                                for a in ("sign_flip", "blowup")},
        "comm_step_us": {"mean": t_mean, "trimmed": t_trim,
                         "median": t_med},
        "kernel_comm_step_us": {"mean": k_mean, "trimmed": k_trim,
                                "median": k_med},
        "robust_overhead_ratio": max(t_trim, t_med) / t_mean,
        "kernel_robust_overhead_ratio": max(k_trim, k_med) / k_mean,
        "robust_overhead_ratio_s_eq_c": t_rob_sc / t_mean_sc,
        "overhead_shape": {"s": s_prod, "trim_k": 1, "d": D},
        "identity_bitwise_ok": identity_ok,
        "deterministic_replay_ok": replay_ok,
        "int8_wire_max_dev": wire_dev,
        "acceptance": {"robust_ratio_max": 2.0, "overhead_ratio_max": 1.5,
                       "mean_control_must_stall": True,
                       "identity_bitwise": True, "replay_bitwise": True,
                       "int8_wire_dev_max": 0.25},
        "config": {**rbench.config(), "trim_k": rb.trim_k, "f_byz": F_BYZ,
                   "max_rounds": z["robust_rounds"], "time_d": D,
                   "attack_metric": "rel_sq_dist_to_honest_subset_optimum",
                   "byzantine": [int(i) for i in np.flatnonzero(rb.byz)]},
    }


def robust_accepted(res: dict) -> bool:
    """The robust bench's acceptance without its overhead bound (a time,
    reported and not gated): both robust aggregators within 2x the
    fault-free rounds under both attacks, both mean controls stall, the
    replay and the identity bitwise, the int8 deviation at most 0.25."""
    return (all(r is not None and r <= 2.0 for r in res["ratios"].values())
            and all(res["mean_control_stalls"].values())
            and res["deterministic_replay_ok"]
            and res["identity_bitwise_ok"]
            and res["int8_wire_max_dev"] <= 0.25)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("faults", "quant", "robust"),
                    default=None, help="run one bench (default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's REPRO_BENCH_SMOKE=1 size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if os.path.basename(args.out).startswith("BENCH_"):
        print("convex_bench: refusing to write a BENCH_*.json (the "
              "reference's artifacts)", file=sys.stderr)
        return 2
    bench = ConvexBench.for_bench(args.smoke, args.device)
    out = {"device": str(bench.device), "smoke": args.smoke}
    if bench.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(bench.device)
    for name, fn in (("faults", run_faults), ("quant", run_quant),
                     ("robust", run_robust)):
        if args.only not in (None, name):
            continue
        t0 = time.perf_counter()
        out[name] = fn(bench)
        out[name]["seconds"] = time.perf_counter() - t0
        for r in out[name]["rows"]:
            print(f"[convex_bench] {name} {json.dumps(r)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[convex_bench] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
