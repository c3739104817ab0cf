"""The paper's experiments on the port: Figs. 2-3 and Tables 1-2.

The port's driver for ``benchmarks/paper_fig2.py``, ``paper_fig3.py``,
``paper_table1.py`` and ``paper_table2.py``, with their problems,
step sizes, round counts and record points: TAMUNA (``core/tamuna.py``)
against the baselines (``core/baselines.py``) on l2-logistic regression
in float64, each algorithm's TotalCom (``up + alpha * down`` floats per
client) to 1e-6 of the initial gap.

``fig2``    w8a-like, n > d (d = 300), full and 10% participation,
            alpha in {0, 0.1}: TAMUNA, Scaffold, 5GCS, Scaffnew (full);
``fig3``    real-sim-like, d > n (d = 2048, or 20958 at paper scale),
            the same without 5GCS;
``table1``  UpCom to the target at c = n/4 beside each formula: TAMUNA,
            Scaffold, 5GCS, DIANA;
``table2``  TotalCom at full participation beside each formula: GD,
            Scaffnew, CompressedScaffnew, DIANA, EF21, TAMUNA.

``--paper-scale`` restores n = 1000 and kappa = 1e4 for the figures, as
the reference's flag does.  ``--smoke`` divides every round count by 100
(a port addition, for a quick pass).  The draws are the port's streams
(``tamuna.draw_round``, the baselines' folds), not the reference's
threefry keys, so the traces are the reference's in law, not bitwise.

Writes ``--out`` (default ``chiprun_out/paper_bench.json``), never a
``BENCH_*.json``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.paper_bench --only fig3 \\
      --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from repro_torch._device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_OUT = os.path.join(REPO, "chiprun_out", "paper_bench.json")
EXPERIMENTS = ("fig2", "fig3", "table1", "table2")
ALPHAS = (0.0, 0.1)


# -- the reference's benchmarks/common.py (TotalCom accounting) --------------

def totalcom(trace: dict, alpha: float) -> np.ndarray:
    return trace["up_floats"] + alpha * trace["down_floats"]


def floats_to_accuracy(trace: dict, target: float, alpha: float):
    """First TotalCom value at which suboptimality <= target (None if
    never)."""
    sub = trace["suboptimality"]
    idx = np.argmax(sub <= target)
    if sub[idx] > target:
        return None
    return float(totalcom(trace, alpha)[idx])


# ---------------------------------------------------------------------------

def _rounds(r: int, div: int) -> int:
    return max(1, r // div)


def gap_target(prob) -> float:
    """1e-6 of the suboptimality at x0 = 0."""
    import torch

    return float(prob.suboptimality(torch.zeros_like(prob.x_star))) * 1e-6


def figure_rows(figure: str, traces: Dict[str, Dict[str, dict]],
                target: float) -> list:
    """The reference's rows of a figure: per regime, alpha and algorithm,
    the floats to the target and the final suboptimality."""
    rows = []
    for regime, by_algo in traces.items():
        for alpha in ALPHAS:
            for name, tr in by_algo.items():
                rows.append({
                    "figure": figure, "regime": regime, "alpha": alpha,
                    "algo": name,
                    "floats_to_target": floats_to_accuracy(tr, target,
                                                           alpha),
                    "final_subopt": float(tr["suboptimality"][-1]),
                })
    return rows


def figure_traces(prob, rounds: int, seed: int = 0, div: int = 1,
                  with_5gcs: bool = False,
                  tamuna_traces: Optional[Dict[str, dict]] = None
                  ) -> Dict[str, Dict[str, dict]]:
    """The traces of Fig. 2 (``with_5gcs``) or Fig. 3 on ``prob``: per
    regime (``full``, ``pp10``), TAMUNA for ``rounds`` rounds (or the
    given ``tamuna_traces[regime]``), Scaffold at half the GD step with
    ``L = 1/p`` local steps for at most 2000 rounds, 5GCS for 500 rounds
    of 300 inner steps, and Scaffnew for 12,000 iterations at full
    participation; every count divided by ``div``."""
    from repro_torch.core import baselines, tamuna

    gamma = 2.0 / (prob.L + prob.mu)
    out = {}
    for c_frac, regime in ((1.0, "full"), (0.1, "pp10")):
        c = max(2, int(round(c_frac * prob.n)))
        cfg = tamuna.TamunaConfig.tuned(prob, c=c)
        traces = {}
        if tamuna_traces is not None and regime in tamuna_traces:
            traces["tamuna"] = tamuna_traces[regime]
        else:
            traces["tamuna"] = tamuna.run(prob, cfg, _rounds(rounds, div),
                                          seed=seed, record_every=10)
        traces["scaffold"] = baselines.run_scaffold(
            prob, 0.5 * gamma, local_steps=max(1, int(1 / cfg.p)), c=c,
            num_rounds=_rounds(min(rounds, 2000), div), seed=seed,
            record_every=10)
        if with_5gcs:
            traces["5gcs"] = baselines.run_5gcs(
                prob, 1.0 / math.sqrt(prob.mu * prob.L), c=c,
                inner_steps=300, num_rounds=_rounds(500, div), seed=seed,
                record_every=10)
        if c == prob.n:
            traces["scaffnew"] = baselines.run_scaffnew(
                prob, gamma, p=cfg.p, num_iters=_rounds(12000, div),
                seed=seed, record_every=50)
        out[regime] = traces
    return out


def fig2(device, paper_scale: bool = False, seed: int = 0,
         div: int = 1) -> list:
    """``benchmarks/paper_fig2.py``: w8a-like, n > d."""
    from repro_torch.core import problems

    prob = problems.make_logreg_problem(
        n=1000 if paper_scale else 64, d=300, samples_per_client=8,
        kappa=1e4 if paper_scale else 1e3, seed=seed, name="w8a-like",
        device=device)
    traces = figure_traces(prob, 8000 if paper_scale else 4000, seed, div,
                           with_5gcs=True)
    return figure_rows("fig2", traces, gap_target(prob))


def fig3(device, paper_scale: bool = False, seed: int = 0,
         div: int = 1) -> list:
    """``benchmarks/paper_fig3.py``: real-sim-like, d > n."""
    from repro_torch.core import problems

    prob = problems.make_logreg_problem(
        n=1000 if paper_scale else 64, d=20958 if paper_scale else 2048,
        samples_per_client=4, kappa=1e4 if paper_scale else 1e3,
        seed=seed, name="realsim-like", device=device)
    traces = figure_traces(prob, 8000 if paper_scale else 4000, seed, div)
    return figure_rows("fig3", traces, gap_target(prob))


def table1(device, seed: int = 0, div: int = 1) -> list:
    """``benchmarks/paper_table1.py``: UpCom (alpha = 0) at c = n/4."""
    from repro_torch.core import baselines, problems, tamuna

    n, d, kappa = 64, 300, 1e3
    prob = problems.make_logreg_problem(n=n, d=d, samples_per_client=8,
                                        kappa=kappa, seed=seed,
                                        device=device)
    c = n // 4
    k = prob.kappa
    gamma = 2.0 / (prob.L + prob.mu)
    theo = {
        "diana-pp": (1 + d / c) * k + d * n / c,
        "scaffold": d * k + d * n / c,
        "5gcs": d * math.sqrt(k) * math.sqrt(n / c) + d * n / c,
        "tamuna": (math.sqrt(d * k * n / c)
                   + d * math.sqrt(k) * math.sqrt(n) / c + d * n / c),
    }
    target = gap_target(prob)
    cfg = tamuna.TamunaConfig.tuned(prob, c=c)
    traces = {
        "tamuna": tamuna.run(prob, cfg, _rounds(2500, div), seed=seed,
                             record_every=10),
        "scaffold": baselines.run_scaffold(
            prob, 0.5 * gamma, local_steps=max(1, int(1 / cfg.p)), c=c,
            num_rounds=_rounds(2500, div), seed=seed, record_every=10),
        "5gcs": baselines.run_5gcs(
            prob, 1.0 / math.sqrt(prob.mu * prob.L), c=c, inner_steps=300,
            num_rounds=_rounds(500, div), seed=seed, record_every=10),
        "diana-pp": baselines.run_diana(
            prob, 0.5 / prob.L, k=8, num_rounds=_rounds(10000, div),
            seed=seed, record_every=50),
    }
    if theo["tamuna"] != min(theo.values()):
        raise AssertionError(f"TAMUNA's UpCom formula is not the least: "
                             f"{theo}")
    return [{
        "table": "table1", "algo": name, "upcom_theory": theo[name],
        "upcom_measured": floats_to_accuracy(traces[name], target, 0.0),
        "final_subopt": float(traces[name]["suboptimality"][-1]),
    } for name in theo]


def table2(device, seed: int = 0, div: int = 1) -> list:
    """``benchmarks/paper_table2.py``: TotalCom at full participation."""
    from repro_torch.core import baselines, problems, tamuna, theory

    n, d, kappa = 64, 300, 1e3
    prob = problems.make_logreg_problem(n=n, d=d, samples_per_client=8,
                                        kappa=kappa, seed=seed,
                                        device=device)
    k = prob.kappa
    gamma = 2.0 / (prob.L + prob.mu)
    target = gap_target(prob)
    cfg = tamuna.TamunaConfig.tuned(prob, c=n)
    traces = {
        "gd": baselines.run_gd(prob, gamma, _rounds(60000, div),
                               record_every=200),
        "scaffnew": baselines.run_scaffnew(
            prob, gamma, p=cfg.p, num_iters=_rounds(20000, div), seed=seed,
            record_every=100),
        "compressed_scaffnew": baselines.run_compressed_scaffnew(
            prob, gamma, p=cfg.p, s=cfg.s, num_iters=_rounds(20000, div),
            seed=seed, record_every=100),
        "diana": baselines.run_diana(
            prob, 0.5 / prob.L, k=8, num_rounds=_rounds(10000, div),
            seed=seed, record_every=50),
        "ef21": baselines.run_ef21(
            prob, 0.5 / prob.L, k=1, num_rounds=_rounds(6000, div),
            seed=seed, record_every=50),
        "tamuna": tamuna.run(prob, cfg, _rounds(4000, div), seed=seed,
                             record_every=20),
    }
    theo0 = {
        "gd": theory.gd_totalcom(k, d, 0.0),
        "scaffnew": theory.scaffnew_totalcom(k, d, 0.0),
        "diana": (1 + d / n) * k + d,
        "ef21": d * k,
        "compressed_scaffnew": (math.sqrt(d) * math.sqrt(k)
                                + d * math.sqrt(k) / math.sqrt(n) + d),
        "tamuna": (math.sqrt(d) * math.sqrt(k)
                   + d * math.sqrt(k) / math.sqrt(n) + d),
    }
    return [{
        "table": "table2", "algo": name, "alpha": alpha,
        "totalcom_theory_alpha0": theo0[name],
        "totalcom_measured": floats_to_accuracy(tr, target, alpha),
        "final_subopt": float(tr["suboptimality"][-1]),
    } for alpha in ALPHAS for name, tr in traces.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=EXPERIMENTS, default=None,
                    help="run one experiment (default: all)")
    ap.add_argument("--paper-scale", action="store_true",
                    help="n = 1000, kappa = 1e4 for the figures")
    ap.add_argument("--smoke", action="store_true",
                    help="every round count divided by 100")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if os.path.basename(args.out).startswith("BENCH_"):
        print("paper_bench: refusing to write a BENCH_*.json (the "
              "reference's artifacts)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    div = 100 if args.smoke else 1
    runs = {
        "fig2": lambda: fig2(device, args.paper_scale, args.seed, div),
        "fig3": lambda: fig3(device, args.paper_scale, args.seed, div),
        "table1": lambda: table1(device, args.seed, div),
        "table2": lambda: table2(device, args.seed, div),
    }
    out = {"device": str(device), "paper_scale": args.paper_scale,
           "smoke": args.smoke}
    if device.type == "cuda":
        import torch

        out["device_name"] = torch.cuda.get_device_name(device)
    for name in EXPERIMENTS:
        if args.only not in (None, name):
            continue
        t0 = time.perf_counter()
        out[name] = {"rows": runs[name]()}
        out[name]["seconds"] = time.perf_counter() - t0
        for r in out[name]["rows"]:
            print(f"[paper_bench] {json.dumps(r)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[paper_bench] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
