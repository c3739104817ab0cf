"""End to end: pretrain a language model with TAMUNA-DP
(``examples/train_lm.py`` on the port).

Trains the reduced gemma2-2b on the synthetic heterogeneous token
pipeline over 4 clients (cohort 4, s = 3) through
``repro_torch.dist.rounds.run_rounds``: the batches are sampled on the
device, and each round runs its local steps and one compressed comm step
on the client-stacked workspace.  The reference's (data=4, model=2) host
mesh has no counterpart: the 4 clients are rows of one device's
workspace.

  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
      [--rounds 40] [--big] [--device cpu]

``--big`` takes a ~100M-parameter config (8 layers, d_model 768, d_ff
3072, vocab 32768); the default is a fast smoke-scale run of the same
path.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--big", action="store_true",
                    help="~100M parameters (much slower on the CPU)")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="default 64, 256 with --big")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch import metrics
    from repro_torch._device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, tamuna_dp

    device = resolve_device(args.device)
    n = 4
    cfg = registry.get_reduced_config("gemma2-2b")
    seq = args.seq_len or (256 if args.big else 64)
    if args.big:
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=768, n_heads=8, n_kv_heads=4,
            head_dim=96, d_ff=3072, vocab=32768, sliding_window=1024)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=4, s=3, p=0.34)
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=device)
    print(f"model: {cfg.name} ({state.spec.d_total / 1e6:.1f}M "
          f"params/client) on {device}, clients={n}, cohort={tcfg.c}, "
          f"s={tcfg.s}, p={tcfg.p}")
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=seq, per_client_batch=2, vocab=512, seed=0,
                   n_clients=n), cfg, device)
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=args.rounds,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=8,
        flush_every=5, logger=metrics.MetricLogger(print_every=5))
    last = rows[-1]
    print(f"round {last['round']:4d}  local_steps {last['local_steps']:5d}  "
          f"loss {last['loss']:.4f}")
    print("done: the loss should have dropped well below ln(vocab) = "
          f"{np.log(512):.2f}")
    return 0 if all(np.isfinite(r["loss"]) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
