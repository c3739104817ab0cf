"""Partial participation as robustness: stragglers and availability
(``examples/availability_sim.py`` on the port).

Every client gets a latency (log-normal, with a heavy-tailed straggler
mixture), and full participation (c = n: every round waits for the slowest
client) is compared with TAMUNA at c = n/4 and n/8 (each round waits only
for the slowest member of its own cohort) on simulated wall-clock time to
a target accuracy: more rounds at small c, but much cheaper ones.  The
wall-clock model draws the cohort and each member's jitter once per round
(``wallclock_per_round``).

``--dist`` runs the story on the training engine: a Markov up/down
availability model and inverse-latency weights drive a
``repro_torch.dist.cohort.CohortPlan`` into ``run_rounds(plan=...)``, and
the plan's own cohorts price the simulated wall clock.  ``--dist
--faults`` runs the fault-tolerant round: a ``FaultPlan`` drops uplinks,
and the fault-free run is compared with the quorum policy (survivor
means, cohort resampling and backoff on a quorum miss) and the
``wait_all`` control.  ``--dist --dist-out PATH`` also writes the measured
per-step latency draws as JSON, which
``repro_torch.dist.faults.EmpiricalDelays.from_json`` (and the
reference's) bootstrap per-round fleet latencies from.

The reference's single-device host mesh has no counterpart: the n = 8
clients of ``--dist`` are rows of one device's workspace.  The
latency-model functions are numpy and copied from the reference.

  PYTHONPATH=src python -m repro_torch.examples.availability_sim \\
      [--dist [--faults | --dist-out PATH]] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def straggler_base(n, rng, straggler_frac=0.1):
    """Per-client base latency; ``straggler_frac`` of the fleet is 10x."""
    base = rng.lognormal(mean=0.0, sigma=0.3, size=n)
    base[rng.random(n) < straggler_frac] *= 10.0
    return base


def wallclock_per_round(steps, n, c, base, rng, jitter_sigma=0.2,
                        cohorts=None, samples_out=None):
    """Per-round wall-clock costs: round ``k`` waits for the slowest of
    its own cohort draw with its own jitter, scaled by its local steps.

    ``steps`` is the per-round local-step count; ``cohorts`` (optional,
    per-round client-id arrays) replays an externally chosen schedule
    (e.g. a ``CohortPlan``) instead of uniform draws.  Returns the
    ``(rounds,)`` per-round times; the cumulative clock is their cumsum.

    ``samples_out`` (optional list) collects every per-client per-step
    latency draw (``base[cohort] * jitter``, before the ``L`` scaling),
    the distribution ``--dist-out`` writes.
    """
    times = np.empty(len(steps))
    for k, L in enumerate(steps):
        cohort = (rng.choice(n, size=c, replace=False)
                  if cohorts is None else np.asarray(cohorts[k]))
        jitter = rng.lognormal(0.0, jitter_sigma, size=len(cohort))
        draws = base[cohort] * jitter
        if samples_out is not None:
            samples_out.extend(draws.tolist())
        times[k] = draws.max() * max(int(L), 1)
    return times


def simulate(prob, c, seed=0, rounds=3000, straggler_frac=0.1):
    from repro_torch.core import tamuna

    rng = np.random.default_rng(seed)
    base = straggler_base(prob.n, rng, straggler_frac)
    cfg = tamuna.TamunaConfig.tuned(prob, c=c)
    # record_every=1: the wall-clock model needs each round's local steps
    tr = tamuna.run(prob, cfg, num_rounds=rounds, record_every=1)
    steps = np.diff(np.concatenate([[0], tr["local_steps"]]))
    times = wallclock_per_round(steps, prob.n, c, base, rng)
    return tr, np.cumsum(times)


def convex_main(rounds, device) -> None:
    from repro_torch.core import problems

    prob = problems.make_logreg_problem(
        n=64, d=256, samples_per_client=8, kappa=1000.0, seed=0,
        device=device)
    target = float(prob.suboptimality(prob.x_star * 0.0)) * 1e-6
    print(f"n={prob.n} kappa={prob.kappa:.0f} target={target:.2e}")
    print(f"{'c':>5} {'rounds':>8} {'UpCom floats':>13} "
          f"{'sim wall-clock':>15}")
    for c in (prob.n, prob.n // 4, prob.n // 8):
        tr, clock = simulate(prob, c, rounds=rounds)
        sub = tr["suboptimality"]
        idx = int(np.argmax(sub < target))
        if sub[idx] >= target:
            print(f"{c:>5} {'-':>8} (not reached)")
            continue
        print(f"{c:>5} {tr['rounds'][idx]:>8} {tr['up_floats'][idx]:>13} "
              f"{clock[idx]:>15.1f}")
    print("\nPP trades more rounds for much cheaper rounds: with 10% "
          "stragglers, waiting for the full fleet every round dominates "
          "the cost at c = n.")


def _engine(n, device):
    """The reduced gemma2-2b, its data config and a fresh pipeline."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline

    cfg = registry.get_reduced_config("gemma2-2b")
    dcfg = DataConfig(seq_len=32, per_client_batch=2, vocab=512, seed=0,
                      n_clients=n)
    return cfg, lambda: SyntheticTokenPipeline(dcfg, cfg, device)


def dist_main(rounds, device, dist_out=None) -> bool:
    import torch

    from repro_torch.dist import cohort as cohort_mod
    from repro_torch.dist import rounds as rounds_mod
    from repro_torch.dist import tamuna_dp

    n = 8
    cfg, pipe = _engine(n, device)
    host = np.random.default_rng(0)
    base = straggler_base(n, host, straggler_frac=0.25)
    # stragglers also churn: slow clients fail often and recover slowly
    slow = base > np.median(base)
    avail = cohort_mod.MarkovAvailability(
        p_fail=np.where(slow, 0.3, 0.05), p_recover=np.where(slow, 0.3, 0.9),
        seed=1)
    print(f"training engine: n={n} clients ({cfg.name}), {rounds} rounds, "
          f"Markov availability + inverse-latency weighting\n")
    print(f"{'c':>4} {'steps':>6} {'loss':>8} {'UpCom/client':>13} "
          f"{'sim wall-clock':>15}")
    samples = [] if dist_out else None
    per_round, finite = [], True
    for c in (n, n // 4):
        tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=2, p=0.34)
        plan = cohort_mod.CohortPlan(seed=7, n=n, c=c, availability=avail,
                                     weights=1.0 / base)
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=device)
        state, rows = rounds_mod.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe(), rounds=rounds,
            rng=np.random.default_rng(c),
            generator=torch.Generator().manual_seed(1), max_L=8,
            flush_every=min(10, rounds), plan=plan)
        steps = [row["L"] for row in rows]
        times = wallclock_per_round(
            steps, n, c, base, np.random.default_rng(3),
            cohorts=[plan.cohort(k) for k in range(len(steps))],
            samples_out=samples)
        per_round.extend(times.tolist())
        last = rows[-1]
        finite = finite and all(np.isfinite(r["loss"]) for r in rows)
        print(f"{c:>4} {last['local_steps']:>6} {last['loss']:>8.4f} "
              f"{last['up_floats']:>13.3e} {times.sum():>15.1f}")
    if dist_out:
        arr = np.asarray(samples, np.float64)
        blob = {
            "per_step_latency_s": samples,
            "per_round_s": per_round,
            "n": n,
            "straggler_frac": 0.25,
            "quantiles": {f"p{int(q * 100)}": float(np.quantile(arr, q))
                          for q in (0.5, 0.9, 0.99)},
        }
        os.makedirs(os.path.dirname(os.path.abspath(dist_out)),
                    exist_ok=True)
        with open(dist_out, "w") as f:
            json.dump(blob, f)
        print(f"\n[dist-out] {len(samples)} per-step latency samples "
              f"(p50={blob['quantiles']['p50']:.2f}s "
              f"p99={blob['quantiles']['p99']:.2f}s) -> {dist_out}")
    print("\nidle clients do no work in the cohort-gathered round, and the "
          "plan routes rounds away from slow or offline clients: the "
          "convex story's crossover on the training engine.")
    return finite


def faults_main(rounds, device) -> bool:
    import torch

    from repro_torch.dist import cohort as cohort_mod
    from repro_torch.dist import faults as faults_mod
    from repro_torch.dist import rounds as rounds_mod
    from repro_torch.dist import tamuna_dp

    n, c = 8, 2
    cfg, pipe = _engine(n, device)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=2, p=0.34)
    fp = faults_mod.FaultPlan(seed=11, n=n,
                              model=faults_mod.FaultModel(p_drop=0.25))
    scenarios = [
        ("fault-free", dict()),
        ("quorum", dict(faults=fp, policy="quorum", max_retries=3,
                        backoff0=0.5)),
        ("wait_all+drops", dict(faults=fp, policy="wait_all")),
    ]
    print(f"fault-tolerant training engine: n={n} c={c} ({cfg.name}), "
          f"{rounds} rounds, Bernoulli dropout p_drop=0.25 (deterministic, "
          f"seed=11)\n")
    print(f"{'scenario':>15} {'loss':>8} {'arrivals':>9} {'retries':>8} "
          f"{'q-miss':>7} {'sim wall-clock':>15}")
    finite = True
    for name, kw in scenarios:
        plan = cohort_mod.CohortPlan(seed=7, n=n, c=c)
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=device)
        state, rows = rounds_mod.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe(), rounds=rounds,
            rng=np.random.default_rng(0),
            generator=torch.Generator().manual_seed(1), max_L=8,
            flush_every=min(10, rounds), plan=plan, **kw)
        arr = sum(r.get("arrivals", c) for r in rows)
        ret = sum(r.get("retries", 0) for r in rows)
        miss = sum(r.get("quorum_miss", 0) for r in rows)
        clock = sum(r.get("round_latency_s", 0.0) + max(int(r["L"]), 1)
                    for r in rows)
        finite = finite and all(np.isfinite(r["loss"]) for r in rows)
        print(f"{name:>15} {rows[-1]['loss']:>8.4f} {arr:>9} {ret:>8} "
              f"{miss:>7} {clock:>15.1f}")
    print("\nthe quorum policy pays retries and backoff to keep every round "
          "above quorum with unbiased survivor means; the wait_all control "
          "aggregates whatever arrived at the 1/s scale.")
    return finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist", action="store_true",
                    help="run the straggler story on the training engine "
                         "with an availability-driven cohort plan")
    ap.add_argument("--faults", action="store_true",
                    help="with --dist: the fault-tolerant round (dropout, "
                         "quorum against wait_all)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="rounds per setting (default: 3000 convex, 12 "
                         "--dist)")
    ap.add_argument("--dist-out", default="",
                    help="with --dist: write the measured per-step latency "
                         "draws (JSON)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if (args.faults or args.dist_out) and not args.dist:
        ap.error("--faults and --dist-out need --dist")

    from repro_torch._device import resolve_device

    device = resolve_device(args.device)
    if args.dist and args.faults:
        return 0 if faults_main(args.rounds or 12, device) else 1
    if args.dist:
        return 0 if dist_main(args.rounds or 12, device,
                              dist_out=args.dist_out or None) else 1
    convex_main(args.rounds or 3000, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
