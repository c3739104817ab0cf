"""TAMUNA-DP training driver of the port (``repro.launch.train``'s
synchronous path, one device).

Each round runs ``L ~ Geometric(p)`` local steps on the cohort's rows, then
one compressed comm step, all on ``--device`` (``cuda`` unless the CPU is
asked for).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch gemma2-2b --reduced --rounds 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-client-batch", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--p", type=float, default=0.34)
    ap.add_argument("--cohort", type=int, default=0, help="0 = 3n/4")
    ap.add_argument("--clients", type=int, default=4, help="population n")
    ap.add_argument("--sparsity", type=int, default=2)
    ap.add_argument("--uplink", default="masked_psum",
                    choices=["masked_psum"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="")
    ap.add_argument("--max-L", type=int, default=16,
                    help="cap on the geometric round length")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import metrics
    from repro_torch._device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, tamuna_dp

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (registry.get_reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    n = args.clients
    c = args.cohort or max(2, (3 * n) // 4)
    tcfg = tamuna_dp.DistTamunaConfig(
        gamma=args.gamma, c=c, s=min(args.sparsity, c), p=args.p,
        uplink=args.uplink,
    )
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=args.seed,
                                 device=device)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=args.seq_len,
                   per_client_batch=args.per_client_batch,
                   vocab=min(cfg.vocab, 512), seed=args.seed, n_clients=n),
        cfg, device,
    )
    logger = metrics.MetricLogger(args.log or None)
    t0 = time.time()
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=args.rounds,
        rng=np.random.default_rng(args.seed),
        generator=torch.Generator().manual_seed(args.seed + 1),
        max_L=args.max_L, logger=logger,
    )
    logger.close()
    dt = time.time() - t0
    total_steps = rows[-1]["local_steps"] if rows else 0
    final_loss = rows[-1]["loss"] if rows else float("nan")
    print(f"[train] {args.rounds} rounds / {total_steps} local steps on "
          f"{device} in {dt:.1f}s; final loss {final_loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
