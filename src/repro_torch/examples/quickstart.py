"""Quickstart: the paper's algorithm on the paper's problem
(``examples/quickstart.py`` on the port).

A synthetic w8a-like logistic regression over 64 clients: TAMUNA with
Theorem 3's parameters at 25% participation converges linearly to the
exact solution with a compressed uplink (``ceil(s d / c)`` floats per
client per round), and reaches a target accuracy with fewer uplink floats
than Scaffold at the same participation.  Everything runs in float64 on
``--device``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def floats_to(trace: dict, target: float):
    """The uplink floats at the first record below ``target``, or
    ``None``."""
    idx = int(np.argmax(trace["suboptimality"] < target))
    return (trace["up_floats"][idx]
            if trace["suboptimality"][idx] < target else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.core import baselines, problems, tamuna

    prob = problems.make_logreg_problem(
        n=64, d=256, samples_per_client=8, kappa=1000.0, seed=0,
        device=args.device)
    print(f"problem: n={prob.n} clients, d={prob.d}, kappa={prob.kappa:.0f}")

    # TAMUNA with Theorem-3 tuned parameters, 25% participation
    cfg = tamuna.TamunaConfig.tuned(prob, c=16)
    print(f"tuned: gamma={cfg.gamma:.2e} p={cfg.p:.3f} s={cfg.s} c={cfg.c}"
          f"  (uplink floats/round/client = "
          f"{max(1, -(-cfg.s * prob.d // cfg.c))}, vs d={prob.d} "
          f"uncompressed)")
    trace = tamuna.run(prob, cfg, num_rounds=args.rounds, record_every=250)
    for r, sub, up in zip(trace["rounds"], trace["suboptimality"],
                          trace["up_floats"]):
        print(f"  round {r:5d}  f(x)-f* = {sub:.3e}  "
              f"uplink floats/client = {up}")

    # versus Scaffold (LT + PP, no acceleration) at the same participation
    target = float(prob.suboptimality(prob.x_star * 0.0)) * 1e-6
    sc = baselines.run_scaffold(
        prob, 1.0 / (prob.L + prob.mu), local_steps=int(1 / cfg.p), c=16,
        num_rounds=args.rounds, record_every=20)
    ft, fs = floats_to(trace, target), floats_to(sc, target)
    print(f"\nuplink floats to reach {target:.1e}: TAMUNA={ft}  "
          f"Scaffold={fs}" + (f"  (speedup {fs / ft:.1f}x)"
                              if ft and fs else ""))
    if not np.isfinite(trace["suboptimality"]).all():
        print("non-finite suboptimality", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
