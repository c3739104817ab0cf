"""Federated-learning scenario: the partial-participation and compression
knobs of TAMUNA compared on one problem (``examples/federated_sim.py`` on
the port).

Default (the convex core, float64): sweeps the cohort size c (partial
participation) and the sparsity s (compression) and prints the TotalCom
cost to a target accuracy for each setting, showing that convergence holds
down to c = 2 (the paper's minimum), that the communication sweet spot
follows Theorem 3's ``s = max(2, c / d)``, and that TotalCom is roughly
flat in c (about n / c rounds of c clients each).

``--lm`` runs the same partial-participation sweep on the training engine
(``repro_torch.dist.rounds.run_rounds``) over the reduced gemma2-2b at
n = 8 clients, printing per-cohort loss and uplink floats.  The
reference's 8-device host mesh has no counterpart: the 8 clients are rows
of one device's workspace.

  PYTHONPATH=src python -m repro_torch.examples.federated_sim \\
      [--lm] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def convex_sweep(rounds: int, device) -> None:
    from repro_torch.core import problems, tamuna, theory

    prob = problems.make_logreg_problem(
        n=48, d=128, samples_per_client=8, kappa=500.0, seed=3,
        device=device)
    target = float(prob.suboptimality(prob.x_star * 0.0)) * 1e-5
    print(f"n={prob.n} d={prob.d} kappa={prob.kappa:.0f} "
          f"target={target:.2e}\n")
    print(f"{'c':>4} {'s':>4} {'p':>7} {'rounds':>7} {'UpCom':>10} "
          f"{'TotalCom(a=0.05)':>17}")
    for c in (2, 6, 12, 24, 48):
        for s in (2, 4) if c >= 4 else (2,):
            cfg = tamuna.TamunaConfig.tuned(prob, c=c, s=s)
            tr = tamuna.run(prob, cfg, num_rounds=rounds, record_every=25)
            sub = tr["suboptimality"]
            idx = int(np.argmax(sub < target))
            if sub[idx] >= target:
                print(f"{c:>4} {s:>4} {cfg.p:>7.3f} {'-':>7} (not reached)")
                continue
            up = tr["up_floats"][idx]
            total = up + 0.05 * tr["down_floats"][idx]
            print(f"{c:>4} {s:>4} {cfg.p:>7.3f} {tr['rounds'][idx]:>7} "
                  f"{up:>10} {total:>17.0f}")
    s_star = theory.recommended_s(c=48, d=prob.d, alpha=0.05)
    print(f"\nTheorem 3 recommends s = {s_star} at c = 48, alpha = 0.05")


def lm_sweep(rounds: int, device) -> bool:
    """The cohort sweep on the training engine; whether every loss was
    finite."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds as rounds_mod
    from repro_torch.dist import tamuna_dp

    n = 8
    cfg = registry.get_reduced_config("gemma2-2b")
    dcfg = DataConfig(seq_len=32, per_client_batch=2, vocab=512, seed=0,
                      n_clients=n)
    print(f"LM partial-participation sweep: n={n} clients, {cfg.name}, "
          f"{rounds} rounds each\n")
    print(f"{'c':>4} {'s':>4} {'rounds':>7} {'steps':>6} {'loss':>8} "
          f"{'UpCom/client':>13}")
    finite = True
    for c in (2, 4, 8):
        tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=2, p=0.34)
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=device)
        pipe = SyntheticTokenPipeline(dcfg, cfg, device)
        state, rows = rounds_mod.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=rounds,
            rng=np.random.default_rng(c),
            generator=torch.Generator().manual_seed(1), max_L=8,
            flush_every=rounds)
        last = rows[-1]
        finite = finite and all(np.isfinite(r["loss"]) for r in rows)
        print(f"{c:>4} {tcfg.s:>4} {rounds:>7} {last['local_steps']:>6} "
              f"{last['loss']:>8.4f} {last['up_floats']:>13.3e}")
    print("\nthe loss falls for every cohort size down to c = 2: partial "
          "participation is free robustness (rounds ~ n/c, cost ~ c).")
    return finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lm", action="store_true",
                    help="sweep cohort sizes on the training engine")
    ap.add_argument("--rounds", type=int, default=0,
                    help="rounds per setting (default: 6000 convex, 12 "
                         "--lm)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device

    device = resolve_device(args.device)
    if args.lm:
        return 0 if lm_sweep(args.rounds or 12, device) else 1
    convex_sweep(args.rounds or 6000, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
