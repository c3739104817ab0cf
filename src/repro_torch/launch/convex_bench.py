"""The convex round-count benches of the reference, on the port.

Two of the reference's results run the strongly convex logistic
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
            suboptimality over the last rounds).

The constants, seeds and draws are the reference's: N 16 clients, D 32,
8 samples each, kappa 100, C = N // 4, at most 4000 rounds;
``CohortPlan(seed=7)``, ``FaultPlan(seed=3)``, permutations from
``SeedSequence([7, 97, g, attempt])``, and the quant bench's cohorts and
permutations from ``default_rng(3)``.  ``--smoke`` is the reference's
``REPRO_BENCH_SMOKE=1`` size.  The reference draws the quant bench's wire
seeds from threefry; here they come from the port's own stream
(``rounds.wire_seed(3, g)``) unless ``wire_seeds`` are passed in.

The counts are machine-independent: the reference's ``BENCH_faults.json``
and ``BENCH_quant_comm.json`` hold the targets.  This driver writes its own
JSON (``--out``, by default ``chiprun_out/convex_bench.json``) and never a
``BENCH_*.json``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.convex_bench --smoke \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
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
                kinds=("f32", "f16", "int8", "int4"), tail=20),
    True: dict(n=8, d=16, spc=4, kappa=50.0, target_rel=1e-1,
               faults_rounds=80, quant_rounds=60, p_fails=(0.0, 0.2),
               kinds=("f32", "int8"), tail=5),
}
MAX_RETRIES, BACKOFF0 = 3, 1.0
BITS = {"f32": 32, "f16": 16, "int8": 8, "int4": 4}


class ConvexBench:
    """A convex problem's TAMUNA rounds with the plain comm step: the
    Theorem-3 tuned config at cohort ``c``, ``L = round(1/p)`` local
    steps, and the bench's ``size`` (``SIZES``; None outside a bench)."""

    def __init__(self, prob, c: int, size: Optional[dict] = None):
        from repro_torch.core import tamuna

        self.prob, self.size = prob, size
        self.device = prob.device
        self.n, self.d, self.c = prob.n, prob.d, c
        self.cfg = tamuna.TamunaConfig.tuned(prob, c=c)
        self.L = max(1, round(1.0 / self.cfg.p))
        self.scale = self.cfg.eta / self.cfg.gamma
        self.gap0 = self.suboptimality(torch.zeros(
            self.d, dtype=torch.float64, device=self.device))
        self.target = (None if size is None
                       else self.gap0 * size["target_rel"])

    @classmethod
    def for_bench(cls, smoke: bool, device) -> "ConvexBench":
        """The reference benches' problem (``SIZES``) on ``device``."""
        from repro_torch.core import problems

        z = SIZES[bool(smoke)]
        prob = problems.make_logreg_problem(
            n=z["n"], d=z["d"], samples_per_client=z["spc"],
            kappa=z["kappa"], seed=0, device=resolve_device(device))
        return cls(prob, max(2, z["n"] // 4), z)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("faults", "quant"), default=None,
                    help="run one bench (default: both)")
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
    for name, fn in (("faults", run_faults), ("quant", run_quant)):
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
