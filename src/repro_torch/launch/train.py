"""TAMUNA-DP training driver of the port (``repro.launch.train``'s
synchronous path, one device).

Each round runs ``L ~ Geometric(p)`` local steps on the cohort's rows, then
one compressed comm step, all on ``--device`` (``cuda`` unless the CPU is
asked for).  ``--robust-agg``/``--trim-k`` pick the combiner;
``--adversary``/``--f-byz`` make a seeded Byzantine fraction of the clients
send garbage every round, which the adaptive payload guard and the robust
combiner face (the fault-tolerant round of ``dist/rounds.py``);
``--reputation`` adds the anomaly-score EWMA that quarantines persistent
offenders from a ``CohortPlan``'s cohorts.
``--wire-precision`` narrows the UpCom payload (DESIGN.md §13: f16/bf16
casts, int8/int4 stochastic codes, ``auto`` per leaf size) and
``--wire-down`` quantizes the DownCom broadcast too.  ``--uplink block_rs``
takes the blocked template, ``--comm-impl`` the comm step's path (the CUDA
kernels, or the reference's plain ``ws``/``dense``), and
``--checkpoint-dir``/``--checkpoint-every`` save the state in the
reference's checkpoint format every that many rounds.

``--flush-every`` sets how many rounds' metrics the driver keeps on the
device before it drains them (both drivers).

``--pipeline`` runs the pipelined rounds (``run_rounds_pipelined``):
``--staleness`` rounds in flight, the simulated clock priced by
``--latency-dist``, and ``--round-policy``/``--quorum`` admission at the
deferred commit; it prints the simulated clock.

``--data-parallel N`` runs the rounds on N ranks (ROADMAP A9a): the
client axis is split over them (``sharding.RankRows``: ``ceil(n / N)``
rows a rank) and the comm step is the shard engine, whose collectives
are d-sized sums (``comm_ws.shard_comm``).  The CLI spawns the N ranks
itself, or joins a ``torchrun`` group when ``WORLD_SIZE`` is set (then N
must equal it); rank ``r`` takes ``cuda:(r % cards)``.
``--dist-backend`` is nccl on ``--device cuda`` and gloo on ``--device
cpu`` unless given: nccl takes one card per rank and refuses more ranks
than cards; ranks that share one card pass ``--dist-backend gloo``.
The rows are the same on every rank and rank 0 prints and logs them; at
``--sparsity 2`` they are the one-process run's bitwise.

``--model-parallel M`` adds the model axis (ROADMAP A9b): ``D x M`` ranks
(``D = --data-parallel``), rank ``r`` data index ``r // M`` and model
index ``r % M`` (``sharding.Mesh2D``); each rank holds its blocks of the
leaves under the reference's rules and trains them with the
tensor-parallel layers, the dense family only (``check_model_parallel``;
the other families, a prefix and heads that do not split whole are
ROADMAP A9c and exit with an error).  M ranks that share one card take
``--dist-backend gloo``: nccl refuses more ranks than cards.  The
reputation, checkpoints, the pipelined driver, the inlier attack and
``--comm-impl ws``/``dense`` over ranks are ROADMAP A9d and exit with an
error.

``--arch`` takes every architecture of the registry: the dense family
(internvl2-26b's batches carry its stub frontend's ``prefix_embeds``,
``SyntheticTokenPipeline``, and the loss is on the text positions), the
MoE family (the loss adds the router's load-balance term), RWKV-6, the
Mamba2 hybrid and the encoder-decoder (whisper-tiny: the batches carry its
stub frontend's ``frames``, ``n_frames`` frame embeddings per sequence).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch gemma2-2b --reduced --rounds 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch internvl2-26b --reduced --rounds 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --reduced --rounds 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-tiny --reduced --rounds 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --sparsity 3 --robust-agg trimmed --trim-k 1 --adversary sign_flip \\
      --f-byz 0.25 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --clients 8 --cohort 4 --robust-agg median --adversary sign_flip \\
      --f-byz 0.25 --reputation --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --wire-precision int8 --wire-down --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --uplink block_rs --comm-impl ws --checkpoint-dir /tmp/ckpt \\
      --checkpoint-every 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 4 \\
      --clients 8 --cohort 2 --pipeline --staleness 1 --latency-dist \\
      benchmarks/artifacts/latency_dist.json --round-policy quorum \\
      --quorum 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --data-parallel 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --data-parallel 2 --dist-backend gloo       # two ranks on one card
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --reduced --rounds 2 --data-parallel 4      # nccl, a card per rank
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --rounds 2 \\
      --data-parallel 2 --model-parallel 2 --dist-backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="an architecture of configs.registry (dense, moe, "
                         "rwkv, mamba_hybrid or encdec)")
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
                    choices=["masked_psum", "block_rs"])
    # literal list (= tamuna_dp.COMM_IMPLS)
    ap.add_argument("--comm-impl", default="auto",
                    choices=["auto", "dense", "ws", "pallas"],
                    help="comm-step path: the CUDA kernels over the "
                         "workspace (pallas; auto on the card, the "
                         "kernels' plain versions on the CPU), or the "
                         "reference's plain sparse (ws) and dense-mask "
                         "(dense) steps over the leaves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default="")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--max-L", type=int, default=16,
                    help="cap on the geometric round length")
    ap.add_argument("--flush-every", type=int, default=10,
                    help="drain the rounds' metrics from the device every "
                         "this many rounds (the driver's only wait for the "
                         "device in a fault-free round)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined rounds under bounded staleness: a "
                         "round's commit may lag its local steps by "
                         "--staleness rounds")
    ap.add_argument("--staleness", type=int, default=1,
                    help="pipeline depth tau (0 = the synchronous "
                         "schedule through the split-phase engine)")
    ap.add_argument("--latency-dist", default="",
                    help="a per-step latency export (JSON key "
                         "per_step_latency_s, e.g. benchmarks/artifacts/"
                         "latency_dist.json) that drives the pipelined "
                         "driver's simulated clock")
    ap.add_argument("--round-policy", default="wait_all",
                    choices=["wait_all", "quorum", "deadline"],
                    help="pipelined admission at the deferred commit "
                         "(uplinks past the cutoff are dropped, their "
                         "coordinates untouched)")
    ap.add_argument("--quorum", type=int, default=0,
                    help="quorum size for --round-policy quorum "
                         "(0 = c//2 + 1)")
    ap.add_argument("--robust-agg", default="mean",
                    choices=["mean", "trimmed", "median"],
                    help="per-coordinate combiner over the arrived owner "
                         "values: trimmed drops --trim-k per side, median "
                         "takes the middle; mean (or trimmed with k=0) is "
                         "the mean path, bitwise")
    ap.add_argument("--trim-k", type=int, default=0,
                    help="values trimmed per side for --robust-agg "
                         "trimmed (needs 2k < sparsity)")
    ap.add_argument("--adversary", default="none",
                    choices=["none", "sign_flip", "scale", "inlier"],
                    help="simulate a Byzantine fraction of clients "
                         "(deterministic in --seed): sign-flipped, "
                         "scaled, or collusive-inlier uplinks")
    ap.add_argument("--f-byz", type=float, default=0.0,
                    help="Byzantine client fraction for --adversary")
    ap.add_argument("--reputation", action="store_true",
                    help="EWMA anomaly reputation: quarantine clients "
                         "whose distance to the robust aggregate stays "
                         "high (needs --adversary and --f-byz > 0)")
    # literal list (= wire.WIRE_POLICIES)
    ap.add_argument("--wire-precision", default="f32",
                    choices=["auto", "f32", "bf16", "f16", "int8", "int4"],
                    help="UpCom payload width: f32 is the unquantized "
                         "wire, auto resolves per leaf size (small leaves "
                         "f16, large 8-bit stochastic)")
    ap.add_argument("--wire-down", action="store_true",
                    help="also quantize the DownCom broadcast (needs a "
                         "non-f32 --wire-precision)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="ranks the client axis is split over (spawned "
                         "here, or the torchrun group of WORLD_SIZE)")
    ap.add_argument("--dist-backend", default="",
                    choices=["", "nccl", "gloo"],
                    help="torch.distributed backend of --data-parallel "
                         "(default nccl on cuda, gloo on cpu; ranks that "
                         "share a card pass gloo)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks each leaf is split over (tensor-parallel "
                         "dense layers); the world is --data-parallel x "
                         "this")
    args = ap.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint_dir:
        ap.error("--checkpoint-every needs --checkpoint-dir")
    adversarial = args.adversary != "none" and args.f_byz > 0.0
    if args.reputation and not adversarial:
        ap.error("--reputation needs --adversary and --f-byz > 0")
    if adversarial and args.pipeline:
        ap.error("--adversary runs on the synchronous driver (drop "
                 "--pipeline)")
    if args.wire_down and args.wire_precision == "f32":
        ap.error("--wire-down quantizes the DownCom broadcast; it needs a "
                 "non-f32 --wire-precision")
    if args.data_parallel < 1 or args.model_parallel < 1:
        ap.error("--data-parallel and --model-parallel need at least 1 "
                 "rank each")
    world = args.data_parallel * args.model_parallel
    env_world = int(os.environ.get("WORLD_SIZE", "0"))
    if env_world and env_world != world:
        ap.error(f"WORLD_SIZE={env_world} but --data-parallel x "
                 f"--model-parallel is {world}")
    if args.model_parallel > 1:
        from repro_torch.configs import registry
        from repro_torch.dist import sharding

        cfg = (registry.get_reduced_config(args.arch) if args.reduced
               else registry.get_config(args.arch))
        try:
            sharding.check_model_parallel(cfg, args.model_parallel)
        except ValueError as e:
            ap.error(str(e))
        if args.adversary != "none" and args.f_byz > 0.0:
            ap.error("the fault-tolerant round over model blocks is not "
                     "ported: ROADMAP A9d")
    if world > 1 or env_world:
        for flag, on in (("--reputation", args.reputation),
                         ("--checkpoint-dir", args.checkpoint_dir),
                         ("--pipeline", args.pipeline),
                         ("--adversary inlier", args.adversary == "inlier"),
                         ("--comm-impl ws/dense",
                          args.comm_impl in ("ws", "dense"))):
            if on:
                ap.error(f"{flag} over ranks is not ported: ROADMAP A9d")
        backend = args.dist_backend or ("nccl" if args.device == "cuda"
                                        else "gloo")
        from repro_torch.dist import sharding

        try:
            sharding.check_backend(backend, args.device, world)
        except ValueError as e:
            ap.error(str(e))
        if env_world:  # a torchrun rank
            rank = int(os.environ["RANK"])
            dev = sharding.rank_device(args.device, rank)
            if dev.type == "cuda":
                import torch

                torch.cuda.set_device(dev)
            sharding.init_group(backend, rank, world, "env://")
            import torch.distributed as dist

            try:
                return _train(rank, dev, args)
            finally:
                dist.destroy_process_group()
        if args.device == "cuda":
            # build the kernels here: ranks building at first use race
            from repro_torch.kernels import _build

            _build.build()
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            sharding.spawn(_train, world, backend=backend,
                           device=args.device,
                           init_method=sharding.file_init_method(tmp),
                           args=(args,))
        return 0
    return _train(None, None, args)


def _train(rank, dev, args) -> int:
    """The run: one process (``rank`` None), or rank ``rank`` of the
    initialised group on ``dev`` (a spawned or a torchrun rank)."""
    import numpy as np
    import torch

    from repro_torch import metrics
    from repro_torch._device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import cohort, faults, rounds, tamuna_dp

    device = resolve_device(args.device) if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (registry.get_reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    n = args.clients
    c = args.cohort or max(2, (3 * n) // 4)
    tcfg = tamuna_dp.DistTamunaConfig(
        gamma=args.gamma, c=c, s=min(args.sparsity, c), p=args.p,
        uplink=args.uplink, comm_impl=args.comm_impl,
        robust_agg=args.robust_agg, trim_k=args.trim_k,
        wire_precision=args.wire_precision, wire_down=args.wire_down,
    )
    group = rows = None
    if rank is not None:
        from repro_torch.dist import sharding

        world = args.data_parallel * args.model_parallel
        if args.model_parallel > 1:
            group = sharding.make_mesh(n, args.data_parallel,
                                       args.model_parallel)
            rows = group.rows
        else:
            group = rows = sharding.RankRows.of_group(n)
        # the ranks' intra-op threads share the host's cores
        torch.set_num_threads(min(torch.get_num_threads(), max(
            1, (os.cpu_count() or 1) // world)))
    lead = rank in (None, 0)
    adversarial = args.adversary != "none" and args.f_byz > 0.0
    state = tamuna_dp.init_state(
        cfg, tcfg, n, seed=args.seed, device=device, rows=rows,
        mesh=group if args.model_parallel > 1 else None)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=args.seq_len,
                   per_client_batch=args.per_client_batch,
                   vocab=min(cfg.vocab, 512), seed=args.seed, n_clients=n),
        cfg, device,
    )
    fkw = {}
    if adversarial:
        fkw["faults"] = faults.FaultPlan(
            seed=args.seed, n=n,
            model=faults.FaultModel(adversary=args.adversary,
                                    f_byz=args.f_byz))
        if args.reputation:
            fkw["plan"] = cohort.CohortPlan(args.seed, n, tcfg.c)
            fkw["reputation"] = True
    logger = metrics.MetricLogger(args.log or None) if lead else None
    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    generator = torch.Generator().manual_seed(args.seed + 1)
    if args.pipeline:
        latency = (faults.EmpiricalDelays.from_json(
            args.latency_dist, n=n, seed=args.seed)
            if args.latency_dist else None)
        engine = rounds.make_pipelined_round_fn(
            cfg, tcfg, n, pipe=pipe, max_L=args.max_L, device=device)
        state, rows = rounds.run_rounds_pipelined(
            state, round_fn=engine, rounds=args.rounds, rng=rng,
            generator=generator, p=tcfg.p, staleness=args.staleness,
            logger=logger, checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every, latency=latency,
            policy=args.round_policy, quorum=args.quorum or None,
            flush_every=args.flush_every,
        )
        if rows:
            print(f"[train] simulated clock: {rows[-1]['commit_s']:.2f}s "
                  f"at staleness {args.staleness}")
    else:
        state, rows = rounds.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=args.rounds,
            rng=rng, generator=generator, max_L=args.max_L, logger=logger,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every,
            flush_every=args.flush_every, group=group, **fkw,
        )
    if not lead:
        return 0
    logger.close()
    dt = time.time() - t0
    total_steps = rows[-1]["local_steps"] if rows else 0
    final_loss = rows[-1]["loss"] if rows else float("nan")
    where = (f"{device}" if group is None else
             f"{args.data_parallel * args.model_parallel} ranks "
             f"({args.data_parallel} x {args.model_parallel}; {device} on "
             "rank 0)")
    print(f"[train] {args.rounds} rounds / {total_steps} local steps on "
          f"{where} in {dt:.1f}s; final loss {final_loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
