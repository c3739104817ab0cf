"""The pipelined-rounds sweep of ``benchmarks/pipeline_bench.py``, on the
port: the simulated straggler clock against the staleness.

The reference's tiny dense model (2 layers, d_model 64, 4 heads, 2 kv
heads, d_ff 128, vocab 128, f32; seq 16, 2 sequences per client) at n = 8
clients, c = 2, s = 2, p = 0.5, max_L 8, 40 rounds, with the clock priced
by the measured per-step latency export ``benchmarks/artifacts/
latency_dist.json`` (``faults.EmpiricalDelays``, seed 0).  The sweep:
``tau = 0`` (``wait_all``, the bulk-synchronous baseline) at seeds 0, 1
and 2 for the convergence noise band, then ``tau`` in {1, 2} under
``wait_all`` and under ``quorum`` with q = 1.  Each run reports its
simulated ``clock_s``, final loss, admitted, late-dropped and uncovered
totals, local steps and real seconds; then ``speedup_at_tail`` (the sync
clock over the best ``wait_all`` clock at ``tau >= 1`` whose loss stays in
the sync band widened by its width) and ``tail_loss_within_sync_band``,
as the reference computes them.

Its cohorts are the port's own (``rounds.uniform_cohort`` and
``free_uniform_cohort`` from the seed ``seed + 10``), so its clocks differ
from ``BENCH_pipeline.json``'s; ``run_one(plan=...)`` injects other
cohorts.  It writes its own JSON (``--out``, by default
``chiprun_out/pipeline_bench.json``) and never a ``BENCH_*.json``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.pipeline_bench --smoke \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
LATENCY_DIST = os.path.join(REPO, "benchmarks", "artifacts",
                            "latency_dist.json")
DEFAULT_OUT = os.path.join(REPO, "chiprun_out", "pipeline_bench.json")
N, C, S, P, MAX_L = 8, 2, 2, 0.5, 8


def sizes(smoke: bool) -> Dict[str, Any]:
    """The sweep's rounds, staleness depths and sync seeds (the
    reference's ``REPRO_BENCH_SMOKE=1`` values under ``smoke``)."""
    return {"rounds": 6 if smoke else 40, "taus": (1,) if smoke else (1, 2),
            "sync_seeds": (0,) if smoke else (0, 1, 2)}


def model_config(smoke: bool = False):
    from repro_torch.models.transformer import ModelConfig

    return ModelConfig(name="pipeline-bench-dense", n_layers=2,
                       d_model=32 if smoke else 64,
                       n_heads=2 if smoke else 4, n_kv_heads=2,
                       d_ff=64 if smoke else 128, vocab=128,
                       dtype=torch.float32, remat=False)


def run_one(tau: int, policy: str, quorum: Optional[int] = None,
            seed: int = 0, *, smoke: bool = False, device="cuda",
            latency=None, plan=None) -> Dict[str, Any]:
    """One run of the sweep: a fresh state from ``seed``, the round
    lengths from ``default_rng(seed)``, the permutations and cohorts from
    a generator seeded ``seed + 10`` (or ``plan``), the batches from the
    pipe reseeded ``seed + 10``."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import faults, rounds, tamuna_dp

    cfg = model_config(smoke)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=P)
    if latency is None:
        latency = faults.EmpiricalDelays.from_json(LATENCY_DIST, n=N, seed=0)
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=seed, device=device)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=2, vocab=128, seed=0,
                   n_clients=N), cfg, device)
    pipe.generator.manual_seed(seed + 10)
    engine = rounds.make_pipelined_round_fn(cfg, tcfg, N, pipe=pipe,
                                            max_L=MAX_L, elastic=True,
                                            device=device)
    t0 = time.perf_counter()
    state, rows = rounds.run_rounds_pipelined(
        state, round_fn=engine, rounds=sizes(smoke)["rounds"],
        rng=np.random.default_rng(seed),
        generator=torch.Generator().manual_seed(seed + 10), p=tcfg.p,
        staleness=tau, flush_every=10, latency=latency, policy=policy,
        quorum=quorum, plan=plan)
    secs = time.perf_counter() - t0
    last = rows[-1]
    return {
        "tau": tau, "policy": policy, "quorum": quorum, "seed": seed,
        "clock_s": float(last["commit_s"]), "loss": float(last["loss"]),
        "admitted_total": int(sum(r.get("admitted", C) for r in rows)),
        "late_dropped_total": int(sum(r.get("late_dropped", 0)
                                      for r in rows)),
        "uncovered_total": int(sum(r.get("uncovered", 0) for r in rows)),
        "local_steps": int(last["local_steps"]),
        "seconds": secs, "seconds_per_round": secs / len(rows),
        "finite": bool(all(np.isfinite(r["loss"]) for r in rows)),
    }


def sweep(smoke: bool = False, device="cuda",
          latency=None) -> Dict[str, Any]:
    """The reference's sweep and its headline."""
    sz = sizes(smoke)

    def one(tau, policy, quorum=None, seed=0):
        return run_one(tau, policy, quorum, seed, smoke=smoke,
                       device=device, latency=latency)

    sync_runs = [one(0, "wait_all", seed=s) for s in sz["sync_seeds"]]
    sync = sync_runs[0]
    scenarios = [sync]
    for tau in sz["taus"]:
        scenarios.append(one(tau, "wait_all"))
    for tau in sz["taus"]:
        scenarios.append(one(tau, "quorum", quorum=1))
    losses = [r["loss"] for r in sync_runs]
    band = max(losses) - min(losses)

    def within(loss):
        # inside the sync seed band widened by one band-width each side
        return min(losses) - band <= loss <= max(losses) + band

    candidates = [r for r in scenarios if r["tau"] >= 1
                  and r["policy"] == "wait_all" and within(r["loss"])]
    best = (max(candidates, key=lambda r: sync["clock_s"] / r["clock_s"])
            if candidates else
            next(r for r in scenarios if r["tau"] == sz["taus"][0]
                 and r["policy"] == "wait_all"))
    return {
        "rows": scenarios,
        "sync_seeds": sync_runs,
        "sync_loss_band": [min(losses), max(losses)],
        "speedup_at_tail": sync["clock_s"] / max(best["clock_s"], 1e-12),
        "speedup_tau": best["tau"],
        "tail_loss_within_sync_band": bool(within(best["loss"])),
        "per_tau_speedup": {str(r["tau"]): sync["clock_s"] / r["clock_s"]
                            for r in scenarios if r["policy"] == "wait_all"
                            and r["tau"] >= 1},
        "config": {"n": N, "c": C, "s": S, "rounds": sz["rounds"],
                   "taus": list(sz["taus"]), "uplink": "masked_psum",
                   "p": P, "max_L": MAX_L, "arch": "dense",
                   "d_model": model_config(smoke).d_model, "seq_len": 16,
                   "sync_seeds": list(sz["sync_seeds"])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's REPRO_BENCH_SMOKE=1 size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--latency-dist", default=LATENCY_DIST)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if os.path.basename(args.out).startswith("BENCH_"):
        print("pipeline_bench: refusing to write a BENCH_*.json (the "
              "reference's artifacts)", file=sys.stderr)
        return 2
    from repro_torch._device import resolve_device
    from repro_torch.dist import faults

    device = resolve_device(args.device)
    latency = faults.EmpiricalDelays.from_json(args.latency_dist, n=N,
                                               seed=0)
    t0 = time.perf_counter()
    out = sweep(args.smoke, device, latency)
    out["seconds"] = time.perf_counter() - t0
    out["device"] = str(device)
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    for r in out["rows"] + out["sync_seeds"][1:]:
        print(f"[pipeline_bench] {json.dumps(r)}")
    print(f"[pipeline_bench] speedup_at_tail {out['speedup_at_tail']:.6f} "
          f"at tau {out['speedup_tau']}, tail_loss_within_sync_band "
          f"{out['tail_loss_within_sync_band']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[pipeline_bench] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
