#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train,
run the paper's convex TAMUNA, and serve.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``, and in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc/`` with nvcc
   for sm_90a and prints the build time and ptxas' register and spill
   report;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the paths below (gemma2-2b at published widths cut to 2
   layers, d_total = 745,558,272), timing both with CUDA events:
   ``masked_sum`` and ``h_update`` on an ``(n=4, d)`` f32 workspace with
   an idle row of NaN and a ragged tail; the local step on the largest
   leaf ``(256000, 2304)``; ``masked_sum(counts=True)``, ``robust_sum``
   (trimmed k=1 and median at s=3) and the covered ``h_update`` on an
   ``(n=5, d)`` workspace with a dropped row of NaN, owned +inf/-inf
   entries and tied values, the covered update with 3 of 4 members
   dropped so a quarter of the coordinates is uncovered; the wire's
   kernels: ``masked_sum_dequant`` on ``(4, d)`` int8 codes and its
   counts form on ``(5, d)`` with a dropped row of NaN scales and
   NaN-poisoned chunks in an owned row, ``masked_sum`` (both forms) over
   f16 and bf16 lanes, the f16 form also at the width of ``[wire]``'s own
   f16 group (the small leaves), and the
   quantizer ``wire_quantize`` in int8, int4 and DownCom modes on rows
   with +inf, -inf, NaN and an all-zero chunk, each form with its share of
   its bound, and in int8 and int4 on rows 2-3 alone with ``row0`` = 2 (a
   rank's rows: the whole pack's rows, bitwise); the coordinate-table
   forms at ``[comm_tp]``'s shapes (model rank 0's blocks of the ``auto``
   wire's int8 group, ``(4, 372,768,768)``): ``wire_quantize_at`` (UpCom
   with nonfinite entries, DownCom) with ``comm_ws._group_scales``' scales
   and ``masked_sum_dequant`` in both forms with the scale-column table;
   every UpCom (``masked_sum`` in both forms and every lane,
   ``robust_sum``, ``masked_sum_dequant``) with its share of the byte bound
   and of the sector floor (the owning rows' entries in whole 32-byte
   sectors);
   the convex core's ``compress`` in f64 at the convex paths' shapes
   ``(100, 20958)`` and ``(1000, 20958)`` with their round-0 permutations
   (and the kernel body's own time there, from ``torch.profiler`` or a
   replayed CUDA graph, without the wrapper's host time, and that host
   time per call),
   in f32 on the ``(4, d)`` workspace (slot ``[1, -1, 0, 2]``, c=3, s=2,
   an idle row of NaN), and in its 1-D form at ``(20958,)`` f64 and
   ``(d,)`` f32, each bitwise;
   and the kernels' whole domain (``check_domain_kernels``):
   ``robust_sum`` at s = 17 and s = 32 (trimmed k=2 and median; the
   shared-memory lists, ``robust_sum_large_s``) and ``h_update`` in both
   forms at n = 4097 rows and at a population of 8192 rows (the row list
   and its tiles), bitwise, each with its time and byte bound (and the
   row list's and the tiles' own device times);
4. runs one round of the reduced gemma2-2b config on the card and on the
   CPU (one intra-op thread) with the same injected schedule and batches,
   and compares them:
   the fault-free round, a round with a dropped member and the trimmed
   mean, and an int8 ``wire_down`` round with a dropped member and the
   trimmed mean whose comm step runs on both devices from the same
   trained state and must agree bitwise; the same three on the blocked
   template (``uplink="block_rs"``: the fault-free round, a drop with the
   trimmed mean, int8 ``wire_down`` with a drop, its comm step bitwise);
   an AdamW round with ``microbatches=2`` (one local step; the columns
   where ``g - h`` lies within 1e-5 of 0, where AdamW's near-sign step
   turns the two devices' gradient roundings into up to ``2 gamma``, are
   counted and held to that bound); and a tall-and-thin round of a dense
   model of one layer and width 16 at n = c = 40, s = 2, whose norm
   leaves take the dense fallback (laid after the others; the kernels run
   over the columns before them with the workspace's row pitch); and the
   fault-free round of each new family's reduced config (qwen2-moe-a2.7b,
   qwen3-moe-30b-a3b, rwkv6-7b, zamba2-2.7b at 32 tokens, whisper-tiny
   with its frames); and reduced gemma2-2b's round at 2304 tokens (1
   sequence per client: the blockwise attention with its recomputing
   backward under ``remat``, a ragged last block), card against CPU
   against float64, leaf by leaf as the families';
5. drives six paths of ``repro_torch.dist.rounds.run_rounds``, each for
   3 rounds (4 on ``[reputation]``) of 2-layer full-width gemma2-2b (seq
   128, 2 sequences per client, max_L 4) with the launch counts set to 0
   just before and read just after:
   ``[train]``  the fault-free round, n=4 clients, cohort c=3, s=2;
   ``[faults]`` the survivor round, n=5, c=4, s=3, a ``CohortPlan``,
                25% uplink drops and 20% NaN payloads, quorum policy,
                quarantine of 2 rounds;
   then data parallelism (``run_dp_paths``): two ranks on the one card
   over gloo (``sharding.spawn``, the kernels built once before), each
   rank's launch counts, peak, collective sizes and host seconds written
   to a file and summed by the parent, the card's memory in use sampled
   with ``nvidia-smi`` while they run:
   ``[train_dp]`` ``[train]`` over the 2 ranks (2 rows each, the shard
                engine's one d-sized sum per round): x, h (row digests)
                and every round's loss bitwise ``[train]``'s, |sum_i h_i|
                / max|h| over the ranks <= 1e-4; host and device seconds
                per round and each sum's host seconds;
   ``[comm_dp]`` four comm steps in turn from ``[train_dp]``'s state
                (n=4): ``auto`` with ``wire_down``, int8 with a dropped
                member, trimmed k=1 and median at c=4, s=3, each bitwise
                the one-process kernel steps' in turn from ``[train]``'s
                (the robust ones, last, up to the sign of zero), the
                largest collective against ``d_total`` (``s`` x the
                column chunk on robust);
   ``[faults_dp]`` ``[faults]`` over the 2 ranks (3 and 2 rows), as 2 +
                1 rounds: after round 1 the rows that did not download
                bitwise ``[faults]``' (a one-process run of rounds 0-1)
                and the downloaded x_bar within 2 ulps of each leaf's
                max|x| (the survivor partials reassociate the three-term
                owner sums; the local steps then carry those ulps into
                every leaf), the losses of rounds 0-1 bitwise; over the 3
                rounds arrivals, guard verdicts, retries and quarantine
                windows equal, |sum_i h_i| / max|h| <= 1e-4, the losses'
                distance printed;
   ``[dp_nccl]`` the reduced round through a one-rank nccl group against
                one process, bitwise (the nccl path launches and takes
                its tensors; one rank partitions nothing);
   then model parallelism (ROADMAP A9b), each path in fresh gloo ranks on
   the card that exit before the next starts (``spawn_tp``), launch
   counts summed over the ranks:
   ``[comm_tp]`` 2 model ranks (one data rank) take their blocks of
                ``[train]``'s state (mapped from this process) and run
                ``COMM_TP``'s five steps in turn: f32 mean, survivor with
                a drop, ``auto`` with ``wire_down`` (the int8 blocks'
                coordinate-table forms), int8 with a drop, trimmed k=1 at
                c=4, s=3; each bitwise the one-process kernel step's
                blocks (robust up to the sign of zero); prints the scales'
                ``MAX`` element counts;
   ``[train_tp]`` ``[train]``'s schedule on 2 model ranks, 3 rounds: the
                first member step's loss and gradients within
                ``TP_STEP_FACTOR`` times the one process's distance from
                float64 (made on the card here), L equal, finite losses,
                |sum_i h_i| / max|h| <= 1e-4; per round host s, device
                ms, the activation sums' seconds;
   ``[train_dp_tp]`` 2 x 2 ranks, 2 rounds: x, h (block row digests) and
                losses bitwise ``[train_tp]``'s after 2 rounds, the data
                group's sums no larger than a block;
   ``[robust]`` the robust round, n=5, c=4, s=3, 20% drops, one
                sign-flipping Byzantine client, quorum, trimmed mean k=1
                behind the adaptive payload guard;
   ``[reputation]`` the robust round with the anomaly reputation, n=5,
                c=4, s=3, a ``CohortPlan``, one sign-flipping client,
                quorum, trimmed mean k=1, ``reputation=True``: prints each
                round's ``anomaly_max``, the quarantine windows and
                ``anomaly_scores``' own time on a full-width workspace;
                gated on the flipped client's quarantine once it arrived
                unguarded and no honest client's;
   ``[wire]``   the quantized wire, n=4, c=3, s=2, ``auto`` (the norm
                leaves as f16 lanes, the rest int8 codes) with the DownCom
                quantized too; prints the per-client wire bytes;
   ``[wire_faults]`` the survivor round on the int8 wire, n=5, c=4, s=3,
                a ``CohortPlan``, 25% uplink drops, quorum;
   each must have finite losses and launch every kernel of its path; the
   fault-free and survivor paths on the f32 wire must keep sum_i h_i = 0
   (printed, not checked, on the others: a robust combine breaks it by
   design, a quantized numerator by its rounding); every path runs with
   ``remat`` (the model's default) and drains its metrics every round,
   and prints each round's device time (CUDA events between commits)
   beside its wall time; after ``[train]``:
   ``[sync]``   ``[train]``'s rounds with ``flush_every`` 3 under
                ``torch.cuda.set_sync_debug_mode("warn")``: the
                synchronising calls inside the one drain and between
                drains (0, or it fails), with their call sites;
   ``[train_long]`` ``[train]``'s round at 8192 tokens, 1 sequence per
                client, ``flush_every`` 10: layer 0's 4096-token window
                cuts keys, the blockwise attention runs 8 blocks each way;
                peak memory, each round's device seconds; gated as
                ``[train]`` but for sum_i h_i = 0, gated per leaf on its
                f32 rounding bound as ``[train_whisper]``, a lost owner
                planted in a fourth round over 1000 times it;
   ``[memory]`` the model alone at those widths, 2 layers, 8192 tokens, 1
                sequence: peak memory and seconds of one loss and gradient
                with ``remat`` on and off against the recomputing
                Function, autograd through the plain chunk loop and the
                dense path (a fresh process under
                ``REPRO_DISABLE_FLASH=1``, ``smoke_phases.py``); one at
                full depth (26 layers, ``remat``, the Function); the
                Function's f32 gradients against the chunk loop's
                (within 1e-4 of each leaf's largest) and ``remat`` on
                against off in bf16 (bitwise, or the difference printed);
   then ``[train]``'s
   round on the rest of the dense family, gated as ``[train]``:
   ``[train_stablelm]`` stablelm-3b at published widths (q/k/v biases,
                untied head) cut to 6 layers, d_total = 733,427,200, n=4,
                c=3, s=2;
   ``[train_prefix]`` internvl2-26b at published widths cut to 1 layer,
                256 prefix embeddings before 128 text tokens, d_total =
                1,566,590,976 (row offsets past 2^31), n=3, c=2, s=2;
   the new families, gated as ``[train]``:
   ``[train_moe]`` qwen2-moe-a2.7b (60 experts, top-4 unnormalized, the
                fused shared expert and its sigmoid gate, q/k/v biases,
                untied head; the dense dispatch) cut 24 -> 2 layers,
                d_total = 1,763,452,928, n=3, c=2, s=2;
   ``[train_qwen3]`` qwen3-moe-30b-a3b (128 experts, top-8 renormalized,
                GQA 32:4, hd 128) cut 48 -> 1 layer, d_total =
                1,245,452,288, n=3, c=2, s=2;
   ``[train_rwkv]`` rwkv6-7b cut 32 -> 4 layers, d_total = 1,411,567,616,
                n=4, c=3, s=2;
   ``[train_zamba2]`` zamba2-2.7b cut 54 -> 12 layers (two groups: the
                shared block's gradient sums both uses), d_total =
                665,436,480, n=4, c=3, s=2, 32 tokens (one 128-token loss
                printed first, not gated: the reference's scan overflows
                f32 there at its init);
   ``[train_whisper]`` whisper-tiny at published widths and full depth (4
                encoder and 4 decoder layers, 1,500 frames per sequence,
                d_total = 36,501,504) over a federated population, n=128,
                c=16, s=2 (x and h 37.4 GB); sum_i h_i = 0 gated on its
                f32 rounding, per leaf within 1.25 times the bound of
                ``tamuna_dp.h_sum_rounding``, and a planted lost owner
                caught (``run_whisper_path``);
   then the round's options on 2-layer gemma2-2b, n=4, c=3, s=2:
   ``[train_adamw]`` ``local_opt="adamw"``, ``microbatches=2`` (x, h and
                the two moments: 16 rows of 2.98 GB), gated as ``[train]``
                and launching no ``fused_local_step``;
   ``[train_blocked]`` ``uplink="block_rs"`` on the kernel path, gated as
                ``[train]``, then one comm step each of ``comm_impl``
                ``"ws"`` and ``"dense"`` from the trained state against
                the kernel path's (a host copy restores the state between
                impls; 2**-20 of the largest value, bitwise reported);
   ``[train_all_rows]`` ``elastic=False``: every row trains and receives
                the DownCom, ``fused_local_step`` launched n L leaves times
                per round;
   ``[checkpoint]`` the reduced config with AdamW: 4 rounds against 2 +
                ``save_state`` + ``restore_state`` + 2, bitwise, with the
                save and restore times (under ``_smoke/``, removed);
   then the pipelined rounds (``run_rounds_pipelined``), launch counts set
   to 0 before each run and read after:
   ``[pipeline]`` 2-layer gemma2-2b at n=6, c=3, s=2, 6 rounds each, the
                clock priced by ``benchmarks/artifacts/latency_dist.json``:
                ``run_rounds`` (``[pipeline_sync]``) against staleness 0
                (``[pipeline_tau0]``: x and h bitwise by row digests, every
                row's counters equal), staleness 1 ``wait_all``
                (``[pipeline_wait_all]``), staleness 1 quorum q=1
                (``[pipeline_quorum]``, the survivor kernels; uncovered
                coordinates printed per round, > 0 in some round; h left
                at zero, one owner admitted) and q=2
                (``[pipeline_quorum2]``, h moves); each gated as
                ``[train]`` and printing its simulated clock, real seconds
                per round and peak memory;
   three staleness-1 quorum-2 rounds of the reduced config on the card
                against the CPU (same state, batches and schedule; 1e-5);
   ``[pipeline_ckpt]`` the reduced config with AdamW at staleness 1: 6
                rounds against the same run resumed from its mid-flight
                ``pipe_step_3`` for the last 3, bitwise (clock, local steps
                and count included; under ``_smoke/``, removed);
   ``[pipeline_bench]`` ``repro_torch.launch.pipeline_bench``'s sweep
                (the reference's tiny model, n=8, c=2, 40 rounds, tau 0 at
                three seeds, tau 1 and 2 under ``wait_all`` and quorum 1)
                beside BENCH_pipeline.json's rows, gated on finite losses,
                its admissions and BENCH's local steps;
6. builds the paper's Fig. 3 problem at paper scale
   (``benchmarks/paper_fig3.py --paper-scale``: real-sim-like l2-logistic
   regression, n=1000 clients, d=20958, 4 samples each, kappa=1e4, seed
   0) in float64 on the card, prints its set-up time (data, L, Newton),
   holds the first 5 rounds of ``repro_torch.core.tamuna.run`` on the
   card against the CPU (1e-10 relative, x_bar and h), and drives two
   paths of ``run`` with the tuned config (s=2, p=0.2236), launch counts
   set to 0 just before and read just after:
   ``[convex]``      the 10% cohort, c=100, 8000 rounds (Fig. 3's count);
   ``[convex_full]`` full participation, c=1000, 1500 rounds;
   each prints its records (suboptimality, Lyapunov function), the round
   time, peak memory, the launches and Theorem 1's tau beside the
   measured Lyapunov rate, and must keep sum_i h_i = 0 (1e-10 of
   max|h|), end with a finite suboptimality below its start and launch
   ``compress_f64`` exactly twice per round and nothing else;
   ``[convex_comm]`` the plain comm implementations
                     (``comm_ws.cyclic_comm_leaves``, the reference's
                     ``impl="ws"`` and ``impl="dense"``) on the same
                     problem, c=100, s=2, f64 storage: 3 quorum rounds at
                     p_fail 0.2, one int8 ``wire_down`` round and a
                     quorum round with the median combiner, each
                     comm step's ws held against dense (equal values),
                     against ws on the CPU (bitwise) and against the
                     workspace kernel path on an f32 copy (2**-20); ms
                     per comm step of each, peak memory, no launches
                     (the kernel path's median launches ``robust_sum``);
   ``[baselines]``   paper Fig. 3 at paper scale through
                     ``repro_torch.launch.paper_bench``: Scaffold (2000
                     rounds) at both participations and Scaffnew (12,000
                     iterations) at full participation beside the TAMUNA
                     traces of ``[convex]`` and ``[convex_full]``, each
                     algorithm's floats to 1e-6 of the initial gap at
                     alpha 0 and 0.1; gated on finite, falling
                     suboptimalities and no launches;
   ``[convex_bench]`` the reference's convex round-count benches
                     (``benchmarks/faults_bench.py``, the convergence
                     half of ``quant_comm_bench.py``, and
                     ``robust_bench.py``) at their full size through
                     ``repro_torch.launch.convex_bench``, every row beside
                     the BENCH file's, gated on the benches' acceptance
                     (the robust comm step's overhead printed, not gated)
                     and no launches but the robust bench's kernel-path
                     timing;
7. holds ``decode_attention`` against its plain version on the card
   (bf16: 16-key K/V tiles through shared memory, logits and PV on the
   tensor cores; f32: one key per warp per step):
   bf16 queries and cache at gemma2-2b's heads (8, 8, 256) over a
   (8, 32768, 4, 256) cache at pos 0, 4095 and 30000 with the 4096 window
   and globally, softcap 50, within one bf16 ulp, and at the serving
   paths' shapes; f32 queries on f32 and bf16 caches at the reduced
   config's heads within 2e-5; the kernel untouched by NaN in every cache
   row outside the visible keys; timing the kernel, the plain version and
   ``scaled_dot_product_attention`` (softcap off) beside the bound; and
   all three at head_dim 80 (stablelm-3b's (8, 32, 80) queries over an
   (8, 4096, 32, 80) cache: globally without softcap, where SDPA computes
   the same function, in a window, at a tile's and a split's edge, with a
   softcap); and the bf16 instantiation at head_dim 128 (qwen2-moe's
   (8, 16, 128) queries over an (8, 4096, 16, 128) cache, the same cases
   but the softcap, SDPA beside it; qwen3-moe's group 8 globally);
8. serves, launch counts set to 0 just before each path and read just
   after, through ``repro_torch.launch.serve.run``:
   ``[serve_reduced]`` the reduced gemma2-2b (f32) past its window of
                 64, stablelm-3b, deepseek-coder-33b and internvl2-26b, on
                 an f32 and a bf16 cache, card (kernel) vs CPU (plain
                 attention): last logits within 1e-4, greedy tokens equal;
   ``[serve]``   gemma2-2b at published widths and full depth (26
                 layers), batch 8, prompt 448 + 64 generated, bf16: ms per
                 step, tok/s, peak memory, a profiled step; 26 x 512
                 launches, no plain attention, finite logits;
   ``[serve_stablelm]`` stablelm-3b at published widths and full depth
                 (32 layers, head_dim 80), batch 8, prompt 192 + 64
                 generated, bf16: the same measures and gates, 32 x 256
                 launches of the bf16 kernel at head_dim 80;
   ``[serve_long]`` two full-width layers past the 4096 window, batch 4,
                 prompt 4544 + 64: the launches, and the last step rerun
                 from the same cache with plain attention;
   ``[serve_reduced]`` also serves the new families' reduced configs
                 (the bf16-cache step rerun from a copy of the cache taken
                 before it, the recurrent states after it within 1e-4);
   ``[serve_moe]`` qwen2-moe-a2.7b at published widths and full depth (24
                 layers, 14.3e9 parameters, every step the gather
                 dispatch), ``[serve_qwen3]`` qwen3-moe-30b-a3b cut 48 -> 8
                 layers (its f32 init does not fit), ``[serve_rwkv]``
                 rwkv6-7b (32 layers, no attention: no launch) and
                 ``[serve_zamba2]`` zamba2-2.7b (54 layers, the hd-80
                 kernel on each of the 9 shared-block uses), batch 8,
                 prompt 128 + 32 generated, bf16: the same measures and
                 gates as ``[serve]``;
   ``[serve_whisper]`` whisper-tiny at published widths and full depth,
                 batch 8, its 1,500 frames encoded once into the cross K/V
                 (timed), prompt 64 + 64 generated, bf16: the same
                 measures and gates, no launch (its decode takes no
                 ``attend_fn``, as the reference's); ``[serve_reduced]``
                 serves its reduced config card against CPU too;
9. runs ``[examples]``: each of ``repro_torch.examples``' ``main`` on the
   card at small arguments (the convex quickstart, the c/s sweep and the
   crossover, ``--lm``, ``--dist``, ``--dist --faults``, ``train_lm``,
   ``serve_decode``), launch counts set to 0 before and read after, each
   exiting 0.

It takes no options and runs every phase.  ``reduced_round_diag.py``
runs the first reduced round's card, CPU and float64 evaluations in fresh
processes.

Any failure raises and exits non-zero.  The last three lines of standard
output are the kernels' JSON record, the card's name and power limit, and
the device JSON record.

It exits non-zero without a result when no CUDA device is present, and
when it stands in a directory without the rest of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM device-memory rate and dense peaks (NVIDIA data sheet): the
# training kernels do O(1) operations per byte and are bound by bytes;
# decode attention's bound takes the larger of its bytes and operations
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

N, C, S = 4, 3, 2  # clients, cohort, sparsity of the fault-free path
NF, CF, SF = 5, 4, 3  # the same for the survivor and robust paths
GAMMA, P = 0.05, 0.34
# the convex paths: paper Fig. 3 at paper scale (benchmarks/paper_fig3.py
# --paper-scale), real-sim-like logistic regression, and their rounds
CONVEX = dict(n=1000, d=20958, samples_per_client=4, kappa=1e4, seed=0)
CONVEX_ROUNDS = {"convex": 8000, "convex_full": 1500}
# intra-op threads of the CPU side of the reduced rounds
REDUCED_CPU_THREADS = 1
# decode attention: gemma2-2b's heads over a 32k cache (b 8), and the
# reduced config's heads over a 4k cache for the f32 instantiations
DECODE_FULL = dict(b=8, h=8, kvh=4, hd=256, S=32768)
DECODE_F32 = dict(b=8, h=4, kvh=2, hd=64, S=4096)
# head_dim 80 at stablelm-3b's serving shape: its 32 heads (group 1) over
# a 4096-row cache, batch 8
DECODE_HD80 = dict(b=8, h=32, kvh=32, hd=80, S=4096)
# the serving paths: the reduced config past its window of 64; full-depth
# gemma2-2b at 512 rows; two full-width layers past the 4096 window
SERVE_REDUCED = dict(batch=4, prompt_len=72, gen_len=8)
SERVE = dict(batch=8, prompt_len=448, gen_len=64)
SERVE_LONG = dict(batch=4, prompt_len=4544, gen_len=64)
# stablelm-3b at full depth: a shorter prompt than [serve]'s holds its 32
# layers' 256 host-bound steps to ~15 s
SERVE_STABLELM = dict(batch=8, prompt_len=192, gen_len=64)
# the dense family's reduced configs served card against CPU
SERVE_REDUCED_ARCHS = ("gemma2-2b", "stablelm-3b", "deepseek-coder-33b",
                       "internvl2-26b", "qwen2-moe-a2.7b",
                       "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-2.7b",
                       "whisper-tiny")
# the other training paths' configs at published widths, cut in depth so
# x and h fit: stablelm-3b (untied head, q/k/v biases) 32 -> 6 layers at
# N clients, internvl2-26b (the prefix: 256 patch embeddings + 128 text
# tokens) 48 -> 1 layer at 3 clients (a row of 1.57e9 f32)
TRAIN_STABLELM_LAYERS = 6
TRAIN_PREFIX = dict(layers=1, n=3, c=2, s=2)
# the tall-and-thin round: a dense model of one layer and width 16 at
# n = c = 40, s = 2, whose norm leaves (D = 16, D s = 32 < c) take the
# dense fallback while its other leaves stay on the kernels
TINY_TALL = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1,
                 head_dim=8, d_ff=32, vocab=64)
TALL = dict(n=40, c=40, s=2)
# the pipelined paths: full-width 2-layer gemma2-2b at n=6, c=3, s=2 (two
# disjoint cohorts in flight at staleness 1), their rounds per run, and the
# measured per-step latency export that prices their simulated clock
PIPE = dict(n=6, c=3, s=2)
PIPE_ROUNDS = 6
PIPE_LATENCY = "benchmarks/artifacts/latency_dist.json"
# data parallelism (ROADMAP A9a): two ranks on the one card over gloo
# (nccl takes one card per rank); [comm_dp]'s steps on [train]'s state at
# n = N: (tag, c, s, the step's options, cohort, permutation, the
# members that arrive (None: all)), the DownCom rows and the wire seed
DP_WORLD = 2
COMM_DP = (
    ("auto_down", 3, 2, dict(wire_precision="auto", wire_down=True),
     [0, 2, 3], [2, 0, 1], None),
    ("int8_arrivals", 3, 2, dict(wire_precision="int8"), [0, 2, 3],
     [2, 0, 1], [True, False, False, True]),
    ("trimmed", 4, 3, dict(robust_agg="trimmed", trim_k=1), [0, 1, 2, 3],
     [3, 0, 2, 1], None),
    ("median", 4, 3, dict(robust_agg="median"), [0, 1, 2, 3], [3, 0, 2, 1],
     None),
)
COMM_DP_DOWN = [True, True, False, True]
COMM_DP_SEED = 0x5EED
# model parallelism (ROADMAP A9b): [train]'s model on TP_MP model ranks
# (one data rank; [train_dp_tp]: TP_DP data ranks) over gloo on the one
# card, and [comm_tp]'s steps in turn on [train]'s state at n = N: as
# COMM_DP's, with COMM_DP_DOWN and COMM_DP_SEED
TP_MP, TP_DP = 2, 2
COMM_TP = (
    ("mean", 3, 2, {}, [0, 2, 3], [2, 0, 1], None),
    ("survivor", 3, 2, {}, [0, 2, 3], [2, 0, 1],
     [True, False, False, True]),
    ("auto_down", 3, 2, dict(wire_precision="auto", wire_down=True),
     [0, 2, 3], [2, 0, 1], None),
    ("int8_arrivals", 3, 2, dict(wire_precision="int8"), [0, 2, 3],
     [2, 0, 1], [True, False, False, True]),
    ("trimmed", 4, 3, dict(robust_agg="trimmed", trim_k=1), [0, 1, 2, 3],
     [3, 0, 2, 1], None),
)
# [train_tp]'s first member step: the loss and each gradient leaf no
# farther from the one process's than this many times the one process's
# own distance to float64 (the reduced model at bf16 on the CPU: at most
# 0.25 per leaf, 0.03 on the loss; PERF.md)
TP_STEP_FACTOR = 1.0
# AdamW's reduced round runs one local step (see check_reduced_adamw_round)
# and gates columns whose g - h lies within ADAM_NEAR0 of 0 at 2 gamma
ADAM_NEAR0 = 1e-5
# the MoE, RWKV-6 and Mamba2-hybrid families: their training paths at
# published widths, cut in depth so x and h fit ([tag], arch, layers, n,
# c, s; PERF.md section 4), each [train]'s round
TRAIN_FAMILIES = (
    ("train_moe", "qwen2-moe-a2.7b", 2, 3, 2, 2),
    ("train_qwen3", "qwen3-moe-30b-a3b", 1, 3, 2, 2),
    ("train_rwkv", "rwkv6-7b", 4, 4, 3, 2),
    ("train_zamba2", "zamba2-2.7b", 12, 4, 3, 2),
)
# sequence lengths other than [train]'s 128 and the reduced rounds' 96:
# zamba2's chunked scan (the reference's factorization) overflows f32 at
# the reference's init once a 64-token chunk's decay passes e^-88
# (ROADMAP C), so its paths take 32 tokens (its [train_zamba2] also prints
# a 128-token loss, not gated)
TRAIN_SEQ = {"zamba2-2.7b": 32}
REDUCED_SEQ = {"zamba2-2.7b": 32}
# and a smaller step: at GAMMA one SGD step of full-width zamba2 moves
# w_in by several times its init scale and the next forward's decays
# overflow the scan (printed by [train_zamba2], not gated; ROADMAP C)
TRAIN_GAMMA = {"zamba2-2.7b": 0.002}
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "rwkv6-7b",
                "zamba2-2.7b", "whisper-tiny")
# their reduced rounds card vs CPU are held against a float64 round, leaf
# by leaf: the card no farther from it than this many times the CPU's
# distance, or 1e-5 (check_reduced_family_round)
F64_RATIO = 4
# their serving paths: batch 8, a 128-token prompt and 32 generated, bf16,
# at full depth but qwen3-moe-30b-a3b (its f32 init, 122 GB, does not fit
# one card: cut 48 -> SERVE_QWEN3_LAYERS); and decode attention at hd 128
# at [serve_moe]'s shape over a 4096-key cache (qwen2-moe: 16 heads, group
# 1), with qwen3-moe's group 8 beside it
SERVE_FAMILY = dict(batch=8, prompt_len=128, gen_len=32)
SERVE_QWEN3_LAYERS = 8
DECODE_HD128 = dict(b=8, h=16, kvh=16, hd=128, S=4096)
DECODE_HD128_G8 = dict(b=8, h=32, kvh=4, hd=128, S=4096)
# the encoder-decoder: whisper-tiny at published widths and full depth
# (36,501,504 parameters, a client row of 146 MB) trains a federated
# population, n = 128 clients, c = 16, s = 2, at [train]'s seq 128, 2
# sequences per client (each with 1,500 frames), gamma, p, 3 rounds and
# max_L; it serves batch 8, the frames encoded once, 64 + 64 tokens
# (within its published 448-token decoder context)
TRAIN_WHISPER = dict(n=128, c=16, s=2)
SERVE_WHISPER = dict(batch=8, prompt_len=64, gen_len=64)
# [train_whisper]'s gate on sum_i h_i = 0, as a share of the f32 rounding
# bound (run_whisper_path)
H_SUM_HEADROOM = 1.25
# [train_long] and the memory table: tokens per sequence past the flash
# threshold (8 blocks of 1024 keys), and the tolerance of the Function's
# f32 gradients against autograd through the chunk loop, of each leaf's
# largest gradient
LONG_SEQ = 8192
LONG_GRAD_TOL = 1e-4
# the reduced round held card vs CPU vs float64 past the threshold (a
# ragged last block of 256 keys)
REDUCED_LONG_SEQ = 2304
# the domain checks' widths: the robust UpCom past s = 16 and h_update past
# 4096 rows (ragged, small enough to keep the phase to seconds)
D_DOMAIN = (1 << 22) + 77
D_DOMAIN_ROWS = (1 << 16) + 3
# the port's examples (repro_torch.examples), each main at small arguments
EXAMPLES = (
    ("quickstart", ["--rounds", "300"]),
    ("federated_sim", ["--rounds", "200"]),
    ("federated_sim", ["--lm", "--rounds", "2"]),
    ("availability_sim", ["--rounds", "200"]),
    ("availability_sim", ["--dist", "--rounds", "2"]),
    ("availability_sim", ["--dist", "--faults", "--rounds", "2"]),
    ("train_lm", ["--rounds", "4"]),
    ("serve_decode", []),
)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_only_ms(fn, name: str, reps: int = 100):
    """The device time of kernel ``name`` per call of ``fn``, without the
    wrapper's host time (which CUDA events around back-to-back calls of a
    small kernel measure instead): ``torch.profiler``'s device time over
    ``reps`` calls, or, where the profiler records no device time, a CUDA
    graph of ``reps`` captured calls replayed under CUDA events.  Returns
    ``(ms, "profiler" or "graph")``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, calls = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += (getattr(ev, "device_time_total", None)
                         or getattr(ev, "cuda_time_total", 0.0))
            calls += ev.count
    if calls and total_us > 0:
        return total_us / calls / 1e3, "profiler"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps, "graph"


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def owned_entries(slot, band, m: int, s: int, cov=None) -> int:
    """How many (row, coordinate) pairs the slots own, on the coordinates
    ``cov`` marks where it is given: the x entries the UpCom must read and
    the h entries the update must touch."""
    per_band = torch.bincount(band if cov is None else band[cov],
                              minlength=m).tolist()
    total = 0
    for sl in slot.tolist():
        if 0 <= sl < m:
            total += sum(cnt for b, cnt in enumerate(per_band)
                         if (sl + b) % m < s)
    return total


def owned_sectors(slot, band, m: int, s: int, width: int,
                  chunk: int = 1 << 26) -> int:
    """How many 32-byte sectors of the rows' ``width``-byte entries hold an
    owned entry: what a kernel that reads whole sectors moves, beside
    ``owned_entries``' count of the owned entries alone.  Rows start on the
    sector grid (``d * width`` a multiple of 32 at full width)."""
    per = 32 // width
    d = band.numel()
    total = 0
    for sl in slot.tolist():
        if not 0 <= sl < m:
            continue
        for a in range(0, d, chunk):
            own = (sl + band[a:a + chunk]) % m < s
            pad = -own.numel() % per
            if pad:
                own = torch.nn.functional.pad(own, (0, pad))
            total += int(own.view(-1, per).any(dim=1).sum())
    return total


def h_update_sector_floor_ms(slot, band, m: int, s: int, down, cov,
                             d: int) -> float:
    """The least time of ``h_update`` when device memory moves whole
    32-byte sectors (rows taken on the sector grid): x_bar and band (and
    the gate) once; each sector of an owning row that holds an owned
    (covered) entry read in x and h and written in h; each sector of a
    down row that holds a (covered) coordinate written, and read as well
    where it also holds an uncovered coordinate, whose bits must stay."""
    from repro_torch.kernels.compress import owned_from_band

    live = (torch.ones(d, dtype=torch.bool, device=band.device)
            if cov is None else cov)
    pad = -d % 8
    sectors = lambda t: torch.nn.functional.pad(t, (0, pad)).view(-1, 8)
    owned = 0
    for sl in slot.tolist():
        if 0 <= sl < m:
            own = owned_from_band(torch.tensor(sl, device=band.device),
                                  band, m, s) & live
            owned += int(sectors(own).any(dim=1).sum())
    exists = sectors(torch.ones(d, dtype=torch.bool, device=band.device))
    lv = sectors(live)
    full = int((lv == exists).all(dim=1).sum())
    partial = int((lv.any(dim=1) & ~(lv == exists).all(dim=1)).sum())
    n_down = slot.numel() if down is None else int(down.sum())
    nbytes = (8 * d + (0 if cov is None else d) + 96 * owned
              + n_down * (32 * full + 64 * partial))
    return bound_ms(nbytes)


def with_floor(rec: dict) -> dict:
    """Adds a record's shares of its byte bound and of its sector floor
    (what a kernel that reads whole 32-byte sectors must move) and prints
    them; returns the record."""
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["share_of_floor"] = rec["sector_floor_ms"] / rec["ms"]
    print(f"[check] {rec['name']}: {rec['ms']:.3f} ms, "
          f"{rec['share_of_bound']:.1%} of the bound "
          f"({rec['bound_ms']:.3f} ms), {rec['share_of_floor']:.1%} of the "
          f"sector floor ({rec['sector_floor_ms']:.3f} ms; the layout's "
          f"ceiling {rec['bound_ms'] / rec['sector_floor_ms']:.1%} of the "
          f"bound)")
    return rec


def max_abs_err(a, b, chunk: int = 1 << 26) -> float:
    """max |a - b| over same-shape tensors, equal values (infinities
    included) and NaN where both are NaN counted as equal, in column
    chunks so no full-size temporary is made; inf where only one side is
    NaN or the two infinities differ."""
    a2, b2 = a.reshape(-1), b.reshape(-1)
    err = 0.0
    for i in range(0, a2.numel(), chunk):
        x, y = a2[i:i + chunk], b2[i:i + chunk]
        if bool((x.isnan() ^ y.isnan()).any()):
            return math.inf
        same = (x == y) | (x.isnan() & y.isnan())
        d = (x - y).abs().masked_fill(same, 0.0)
        err = max(err, float(d.nan_to_num(nan=math.inf).max()))
    return err


def up_bytes(spec, c: int, s: int, policy: str) -> float:
    """Per-client UpCom wire bytes of one round (``make_comm_step``'s
    accounting) without building a comm step."""
    from repro_torch.core import masks
    from repro_torch.dist import wire

    return sum(wire.leaf_up_bytes(masks.column_nnz(D, c, s), D, 1,
                                  wire.resolve_kind(D, policy))
               for D in spec.dims)


def check_uplink_kernels(spec, tcfg, dev):
    """masked_sum and h_update against their plain versions on the full
    workspace; returns their records."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref, uplink

    n, d = N, spec.d_total
    g = torch.Generator(device=dev).manual_seed(1)
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    down = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    x[1] = float("nan")  # the idle row may hold anything
    scale = tcfg.eta_(n) / tcfg.gamma
    owned = owned_entries(slot, band, C, S)
    n_down = int(down.sum())
    print(f"[check] workspace ({n}, {d}) f32, slot {slot.tolist()}, "
          f"down {down.tolist()}, {owned} owned entries")

    xbar = uplink.masked_sum(x, slot, band, C, S)
    xbar_p = ref.masked_sum(x, slot, band, C, S)
    torch.cuda.synchronize()
    ms_err = max_abs_err(xbar, xbar_p)
    ms_tol = 1e-6 * float(xbar_p.abs().max())
    del xbar_p
    if not bool(xbar.isfinite().all()) or ms_err > ms_tol:
        raise AssertionError(f"masked_sum: max abs err {ms_err} > {ms_tol}")
    rec_ms = with_floor({
        "name": "masked_sum", "shape": [n, d],
        "max_abs_err": ms_err, "tolerance": ms_tol,
        "ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S), 2),
        # owned x entries read, band read, x_bar written, slot read
        "bound_ms": bound_ms(4 * (owned + 2 * d + n)),
        # the same with the owning rows' entries in whole 32-byte sectors
        "sector_floor_ms": bound_ms(
            32 * owned_sectors(slot, band, C, S, 4) + 4 * (2 * d + n)),
    })

    h = torch.randn(n, d, generator=g, device=dev).mul_(0.01)
    xk, hk = x.clone(), h.clone()
    uplink.h_update(xk, hk, xbar, slot, band, C, S, scale, down=down)
    ref.h_update(x, h, xbar, slot, band, C, S, scale, down=down)
    torch.cuda.synchronize()
    hu_err = max(max_abs_err(xk, x), max_abs_err(hk, h))
    if hu_err != 0.0:
        raise AssertionError(f"h_update: max abs err {hu_err}, want 0")
    rec_hu = {
        "name": "h_update", "shape": [n, d], "max_abs_err": hu_err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.h_update(
            xk, hk, xbar, slot, band, C, S, scale, down=down), 5),
        "plain_ms": cuda_ms(lambda: ref.h_update(
            x, h, xbar, slot, band, C, S, scale, down=down), 2),
        # owned x read + owned h read and written, x_bar and band read,
        # the down rows of x written, slot and down read
        "bound_ms": bound_ms(4 * (3 * owned + 2 * d + n_down * d + 2 * n)),
    }
    return rec_ms, rec_hu


def check_local_step(spec, dev):
    """fused_local_step against its plain version on every leaf shape of a
    client row, timed at the largest leaf; returns its record."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref
    from repro_torch.kernels.local_step import fused_local_step

    g = torch.Generator(device=dev).manual_seed(2)
    x, gr, h = (torch.randn(spec.d_total, generator=g, device=dev)
                for _ in range(3))
    xs, gs, hs = (comm_ws.leaf_views(t, spec) for t in (x, gr, h))
    err = 0.0
    for name in spec.names:
        got = fused_local_step(xs[name], gs[name], hs[name], GAMMA)
        want = ref.fused_local_step(xs[name], gs[name], hs[name], GAMMA)
        err = max(err, max_abs_err(got, want))
    if err != 0.0:
        raise AssertionError(f"fused_local_step: max abs err {err}, want 0")
    big = max(zip(spec.dims, spec.names))[1]
    xe, ge, he = xs[big], gs[big], hs[big]
    out = torch.empty_like(xe)
    return {
        "name": "fused_local_step", "shape": list(xe.shape),
        "max_abs_err": err, "tolerance": 0.0,
        "ms": cuda_ms(lambda: fused_local_step(xe, ge, he, GAMMA, out=out),
                      10),
        "plain_ms": cuda_ms(lambda: ref.fused_local_step(xe, ge, he, GAMMA),
                            5),
        # x, g, h read, x written
        "bound_ms": bound_ms(16 * xe.numel()),
    }


def check_fault_kernels(spec, dev):
    """masked_sum(counts=True), robust_sum (trimmed k=1 and median) and the
    covered h_update against their plain versions on the ``(NF, d)``
    workspace of the survivor and robust paths; returns their records."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref, uplink

    n, d = NF, spec.d_total
    g = torch.Generator(device=dev).manual_seed(3)
    band = comm_ws.cyclic_band(spec.dims, CF, SF, dev)
    # members 0-3 on template columns 1, -, 0, 3 (row 1 dropped, its
    # payload NaN), row 4 idle
    slot = torch.tensor([1, -1, 0, 3, -1], dtype=torch.int32, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    x[1] = float("nan")
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, ::7] = x[0, ::7]  # tied owner values
    owned = owned_entries(slot, band, CF, SF)
    print(f"[check] workspace ({n}, {d}) f32, slot {slot.tolist()}, "
          f"{owned} owned entries")
    # owned x entries read, band read, two (d,) outputs written, slot read
    uplink_bound = bound_ms(4 * (owned + 3 * d + n))
    # the same with the owning rows' entries in whole 32-byte sectors
    uplink_floor = bound_ms(32 * owned_sectors(slot, band, CF, SF, 4)
                            + 4 * (3 * d + n))

    num, cnt = uplink.masked_sum(x, slot, band, CF, SF, counts=True)
    num_p, cnt_p = ref.masked_sum_counts(x, slot, band, CF, SF)
    torch.cuda.synchronize()
    err = max(max_abs_err(num, num_p), max_abs_err(cnt, cnt_p))
    del num, cnt, num_p, cnt_p
    if err != 0.0:
        raise AssertionError(f"masked_sum_counts: max abs err {err}, want 0")
    recs = [with_floor({
        "name": "masked_sum_counts", "shape": [n, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum(
            x, slot, band, CF, SF, counts=True), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_counts(
            x, slot, band, CF, SF), 2),
        "bound_ms": uplink_bound, "sector_floor_ms": uplink_floor,
    })]

    rb = {}
    for kind, k in (("trimmed", 1), ("median", 0)):
        bar, cnt = uplink.robust_sum(x, slot, band, CF, SF, kind=kind, k=k)
        bar_p, cnt_p = ref.robust_sum(x, slot, band, CF, SF, kind, k)
        torch.cuda.synchronize()
        e = max(max_abs_err(bar, bar_p), max_abs_err(cnt, cnt_p))
        print(f"[check] robust_sum {kind} k={k}: max abs err {e}, "
              f"{int(bar.isinf().sum())} inf and {int(bar.isnan().sum())} "
              f"NaN outputs")
        del bar, cnt, bar_p, cnt_p
        if e != 0.0:
            raise AssertionError(f"robust_sum {kind}: max abs err {e}, "
                                 "want 0")
        rb[kind] = (e, cuda_ms(lambda: uplink.robust_sum(
            x, slot, band, CF, SF, kind=kind, k=k), 5),
            cuda_ms(lambda: ref.robust_sum(x, slot, band, CF, SF, kind, k),
                    2))
    recs.append(with_floor({
        "name": "robust_sum", "shape": [n, d],
        "max_abs_err": max(v[0] for v in rb.values()), "tolerance": 0.0,
        # the trimmed mean is the path's combiner; the median's times
        # ride along
        "ms": rb["trimmed"][1], "plain_ms": rb["trimmed"][2],
        "median_ms": rb["median"][1], "median_plain_ms": rb["median"][2],
        "bound_ms": uplink_bound, "sector_floor_ms": uplink_floor,
    }))

    # 3 of the 4 members dropped: a quarter of the coordinates uncovered
    slot_c = torch.tensor([1, -1, -1, -1, -1], dtype=torch.int32,
                          device=dev)
    down = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32, device=dev)
    x_bar, cnt = uplink.masked_sum(x, slot_c, band, CF, SF, counts=True)
    covered = cnt > 0
    x_bar.div_(cnt.clamp_(min=1.0))
    del cnt
    n_cov = int(covered.sum())
    owned_c = owned_entries(slot_c, band, CF, SF)
    n_down = int(down.sum())
    print(f"[check] covered h_update: slot {slot_c.tolist()}, down "
          f"{down.tolist()}, {d - n_cov} of {d} coordinates uncovered")
    scale = 0.37
    h = torch.randn(n, d, generator=g, device=dev).mul_(0.01)
    xk, hk = x.clone(), h.clone()
    uplink.h_update(xk, hk, x_bar, slot_c, band, CF, SF, scale, down=down,
                    covered=covered)
    ref.h_update(x, h, x_bar, slot_c, band, CF, SF, scale, down=down,
                 covered=covered)
    torch.cuda.synchronize()
    err = max(max_abs_err(xk, x), max_abs_err(hk, h))
    if err != 0.0:
        raise AssertionError(f"h_update_covered: max abs err {err}, want 0")
    recs.append({
        "name": "h_update_covered", "shape": [n, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.h_update(
            xk, hk, x_bar, slot_c, band, CF, SF, scale, down=down,
            covered=covered), 5),
        "plain_ms": cuda_ms(lambda: ref.h_update(
            x, h, x_bar, slot_c, band, CF, SF, scale, down=down,
            covered=covered), 2),
        # the gate read; on covered coordinates band and x_bar read and
        # the down rows of x written; owned x read, owned h read and
        # written; slot and down read
        "bound_ms": bound_ms(d + 4 * (2 * n_cov + n_down * n_cov
                                      + 3 * owned_c + 2 * n)),
    })
    return recs


def check_domain_kernels(dev):
    """The kernels past the sizes their first instantiations stage:
    ``robust_sum`` at s = 17 and s = 32, trimmed (k = 2) and median, on
    ``smoke_phases.robust_domain_inputs`` at ``D_DOMAIN`` (NaN rows, ties,
    +-inf and +-0.0; each owner read once into shared-memory lists,
    ``robust_sum_large_s``), and ``h_update`` in both forms on
    ``smoke_phases.h_update_domain_inputs`` at n = 4097 (64 in the cohort,
    a quarter of the rows downloading) and at ``H_POPULATION`` (the cohort
    downloading; the row list and its tiles, ``h_update_large_n``,
    ``h_update_covered_large_n``), each bitwise against its plain version
    (NaN where it is NaN), timed beside its byte bound as
    ``smoke_phases.py --phase domain`` times any tree.  Returns their
    records (the population's under ``population``)."""
    from repro_torch.kernels import _build, ref, uplink
    from smoke_phases import (H_POPULATION, h_update_domain_inputs,
                              robust_domain_inputs)

    d = D_DOMAIN
    recs = []
    rb = {}
    for s in (17, 32):
        x, slot, band, m = robust_domain_inputs(s, d, dev)
        n = x.shape[0]
        owned = owned_entries(slot, band, m, s)
        for kind, k in (("trimmed", 2), ("median", 0)):
            before = _build.launch_counts["robust_sum_large_s"]
            bar, cnt = uplink.robust_sum(x, slot, band, m, s, kind=kind, k=k)
            if _build.launch_counts["robust_sum_large_s"] != before + 1:
                raise AssertionError("robust_sum past s = 16 did not take "
                                     "robust_sum_large_s")
            bar_p, cnt_p = ref.robust_sum(x, slot, band, m, s, kind, k)
            torch.cuda.synchronize()
            e = max(max_abs_err(bar, bar_p), max_abs_err(cnt, cnt_p))
            # the bits, NaN where NaN: a zero's sign is what the sorting
            # network could get wrong, and max_abs_err cannot see it
            nan = bar.isnan()
            same = (bool(torch.equal(nan, bar_p.isnan()))
                    and bool(torch.equal(
                        bar.masked_fill(nan, 0.0).view(torch.int32),
                        bar_p.masked_fill(nan, 0.0).view(torch.int32)))
                    and bool(torch.equal(cnt.view(torch.int32),
                                         cnt_p.view(torch.int32))))
            print(f"[check] robust_sum s={s} {kind} k={k} on ({n}, {d}): "
                  f"max abs err {e}, bitwise {same}, "
                  f"{int(bar.isinf().sum())} inf, {int(nan.sum())} NaN and "
                  f"{int((bar == 0).sum())} zero outputs")
            if e != 0.0 or not same:
                raise AssertionError(f"robust_sum s={s} {kind}: max abs err "
                                     f"{e}, bitwise {same}; want 0, True")
            rb[s, kind] = (cuda_ms(lambda: uplink.robust_sum(
                x, slot, band, m, s, kind=kind, k=k), 5),
                cuda_ms(lambda: ref.robust_sum(x, slot, band, m, s, kind, k),
                        1), bound_ms(4 * (owned + 3 * d + n)))
            print(f"[check] robust_sum s={s} {kind}: {rb[s, kind][0]:.4f} "
                  f"ms, plain {rb[s, kind][1]:.3f} ms, bound "
                  f"{rb[s, kind][2]:.4f} ms")
            del bar, cnt, bar_p, cnt_p
        del x
    recs.append({
        "name": "robust_sum_large_s", "shape": [36, d], "s": 32,
        "max_abs_err": 0.0, "tolerance": 0.0,
        "ms": rb[32, "trimmed"][0], "plain_ms": rb[32, "trimmed"][1],
        "bound_ms": rb[32, "trimmed"][2],
        **{f"s{s}_{kind}_ms": v[0] for (s, kind), v in rb.items()},
        **{f"s{s}_{kind}_plain_ms": v[1] for (s, kind), v in rb.items()},
        "s17_bound_ms": rb[17, "trimmed"][2],
    })

    by_name = {}
    pop = H_POPULATION
    for n, dn, m, s, population in (
            (4097, D_DOMAIN_ROWS, 64, 2, False),
            (pop["n"], pop["d"], pop["cohort"], pop["s"], True)):
        for form in ("h_update", "h_update_covered"):
            name = form + "_large_n"
            # the kernel's operands (made anew for each form), then the
            # plain version's (a copy)
            a = h_update_domain_inputs(n, dn, m, s, population, dev)
            xk, hk, x_bar, slot, down, band = (
                a["x"], a["h"], a["x_bar"], a["slot"], a["down"], a["band"])
            cov = None if form == "h_update" else a["covered"]
            del a
            xp, hp = xk.clone(), hk.clone()
            before = _build.launch_counts[name]
            uplink.h_update(xk, hk, x_bar, slot, band, m, s, 0.37,
                            down=down, covered=cov)
            if _build.launch_counts[name] != before + 1:
                raise AssertionError(f"h_update at n={n} did not take "
                                     f"{name}")
            ref.h_update(xp, hp, x_bar, slot, band, m, s, 0.37, down=down,
                         covered=cov)
            torch.cuda.synchronize()
            err = max(max_abs_err(xk, xp), max_abs_err(hk, hp))
            n_down = int(down.sum())
            print(f"[check] {name} at n={n} ({m} owners' slots, {n_down} "
                  f"down rows) on ({n}, {dn}): max abs err {err}")
            if err != 0.0:
                raise AssertionError(f"{name}: max abs err {err}, want 0")
            nc = dn if cov is None else int(cov.sum())
            owned = owned_entries(slot, band, m, s, cov)
            call = (lambda: uplink.h_update(
                xk, hk, x_bar, slot, band, m, s, 0.37, down=down,
                covered=cov))
            rec = {
                "name": name, "shape": [n, dn], "max_abs_err": err,
                "tolerance": 0.0, "ms": cuda_ms(call, 5),
                "plain_ms": cuda_ms(lambda: ref.h_update(
                    xp, hp, x_bar, slot, band, m, s, 0.37, down=down,
                    covered=cov), 1),
                # (the gate read,) x_bar and band read and the down rows of
                # x written on the (covered) coordinates, x read and h read
                # and written where a row owns a (covered) coordinate, slot
                # and down read
                "bound_ms": bound_ms((0 if cov is None else dn) + 4 * (
                    2 * nc + n_down * nc + 3 * owned + 2 * n)),
                "sector_floor_ms": h_update_sector_floor_ms(
                    slot, band, m, s, down, cov, dn),
            }
            # the row list's and the tiles' own device times; the rest of
            # ms is the two launches' gaps
            for part, kernel in (("list", "h_update_row_list_kernel"),
                                 ("tiles", "h_update_tiles_kernel")):
                rec[f"{part}_ms"], rec["parts_by"] = kernel_only_ms(
                    call, kernel)
            print(f"[check] {name} on ({n}, {dn}): {rec['ms']:.4f} ms "
                  f"({rec['bound_ms'] / rec['ms']:.1%} of the bound "
                  f"{rec['bound_ms']:.4f} ms, "
                  f"{rec['sector_floor_ms'] / rec['ms']:.1%} of the sector "
                  f"floor {rec['sector_floor_ms']:.4f} ms); row list "
                  f"{rec['list_ms']:.4f} ms, tiles {rec['tiles_ms']:.4f} ms "
                  f"({rec['parts_by']})")
            if population:
                by_name[name]["population"] = rec
            else:
                by_name[name] = rec
            del xk, hk, xp, hp
            torch.cuda.empty_cache()
    return recs + list(by_name.values())


def check_wire_kernels(spec, dev):
    """The wire's kernels against their plain versions on full-width
    workspaces: ``masked_sum_dequant`` (both forms), ``masked_sum`` over
    f16 and bf16 lanes (both forms) and ``wire_quantize`` (int8, int4 and
    the DownCom); returns their records."""
    from repro_torch.dist import comm_ws, wire
    from repro_torch.kernels import ref, uplink, wire_pack

    d = spec.d_total
    g = torch.Generator(device=dev).manual_seed(4)
    leaves = [(i, o, D) for i, (o, D) in enumerate(zip(spec.offsets,
                                                       spec.dims))]
    # the leaf starts as host integers (the wrapper's form) and as a
    # tensor on the card (the plain version's)
    lo = tuple([0] + [o + D for _, o, D in leaves])
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    nc = sum(wire.n_chunks(D) for D in spec.dims)
    recs = []

    # -- masked_sum_dequant, (4, d), the [wire] path's shape --------------
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    codes = torch.randint(-127, 128, (N, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(N, nc, generator=g, device=dev).mul_(0.01)
    scales[1] = float("nan")  # the idle row's chunks never leak
    owned = owned_entries(slot, band, C, S)
    sectors = owned_sectors(slot, band, C, S, 1)
    bar = uplink.masked_sum_dequant(codes, scales, lo, slot, band, C, S)
    bar_p = ref.masked_sum_dequant(codes, scales, lo_t, slot, band, C, S)
    torch.cuda.synchronize()
    err = max_abs_err(bar, bar_p)
    if not bool(bar.isfinite().all()) or err != 0.0:
        raise AssertionError(f"masked_sum_dequant: max abs err {err}")
    del bar, bar_p
    recs.append(with_floor({
        "name": "masked_sum_dequant", "shape": [N, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum_dequant(
            codes, scales, lo, slot, band, C, S), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_dequant(
            codes, scales, lo_t, slot, band, C, S), 2),
        # owned codes (1 B) read, the owning rows' scales, band read,
        # x_bar written, the leaf tables and slot read
        "bound_ms": bound_ms(owned + 4 * (3 * nc + 2 * d + 2 * len(leaves)
                                          + N)),
        # the same with the owning rows' codes in whole 32-byte sectors:
        # the least a kernel that reads sectors can move
        "sector_floor_ms": bound_ms(32 * sectors + 4 * (
            3 * nc + 2 * d + 2 * len(leaves) + N)),
    }))
    del codes, scales, band

    # -- masked_sum_dequant(counts=True), (5, d), the [wire_faults] shape --
    band = comm_ws.cyclic_band(spec.dims, CF, SF, dev)
    slot = torch.tensor([1, -1, 0, 3, -1], dtype=torch.int32, device=dev)
    codes = torch.randint(-127, 128, (NF, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(NF, nc, generator=g, device=dev).mul_(0.01)
    scales[1] = float("nan")  # the dropped row
    scales[0, ::1000] = float("nan")  # poisoned chunks of an owned row
    owned = owned_entries(slot, band, CF, SF)
    sectors = owned_sectors(slot, band, CF, SF, 1)
    num, cnt = uplink.masked_sum_dequant(codes, scales, lo, slot, band, CF,
                                         SF, counts=True)
    num_p, cnt_p = ref.masked_sum_dequant(codes, scales, lo_t, slot, band,
                                          CF, SF, counts=True)
    torch.cuda.synchronize()
    err = max(max_abs_err(num, num_p), max_abs_err(cnt, cnt_p))
    n_nan = int(num.isnan().sum())
    print(f"[check] masked_sum_dequant_counts: {n_nan} NaN outputs from "
          f"{int(scales[0].isnan().sum())} poisoned chunks of row 0")
    if err != 0.0 or n_nan == 0:
        raise AssertionError(f"masked_sum_dequant_counts: max abs err {err},"
                             f" {n_nan} NaN")
    del num, cnt, num_p, cnt_p
    recs.append(with_floor({
        "name": "masked_sum_dequant_counts", "shape": [NF, d],
        "max_abs_err": err, "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum_dequant(
            codes, scales, lo, slot, band, CF, SF, counts=True), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_dequant(
            codes, scales, lo_t, slot, band, CF, SF, counts=True), 2),
        # owned codes read, 3 owning rows' scales, band read, num and cnt
        # written, the leaf tables and slot read
        "bound_ms": bound_ms(owned + 4 * (3 * nc + 3 * d + 2 * len(leaves)
                                          + NF)),
        "sector_floor_ms": bound_ms(32 * sectors + 4 * (
            3 * nc + 3 * d + 2 * len(leaves) + NF)),
    }))
    del codes, scales

    # -- masked_sum over f16 and bf16 lanes, (4, d) -------------------------
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    owned = owned_entries(slot, band, C, S)
    sectors = owned_sectors(slot, band, C, S, 2)
    for lane, tag in ((torch.float16, "f16"), (torch.bfloat16, "bf16")):
        x = torch.randn(N, d, generator=g, device=dev).to(lane)
        x[1] = float("nan")
        errs = []
        for counts in (False, True):
            got = uplink.masked_sum(x, slot, band, C, S, counts=counts)
            want = (ref.masked_sum_counts(x, slot, band, C, S) if counts
                    else ref.masked_sum(x, slot, band, C, S))
            torch.cuda.synchronize()
            got = got if counts else (got,)
            want = want if counts else (want,)
            errs += [max_abs_err(a, b) for a, b in zip(got, want)]
            del got, want
        err = max(errs)
        if err != 0.0:
            raise AssertionError(f"masked_sum {tag} lanes: max abs err {err}")
        recs.append(with_floor({
            "name": f"masked_sum_{tag}", "shape": [N, d],
            "max_abs_err": err, "tolerance": 0.0,
            "ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S), 5),
            "plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S),
                                2),
            "counts_ms": cuda_ms(lambda: uplink.masked_sum(
                x, slot, band, C, S, counts=True), 5),
            "counts_plain_ms": cuda_ms(lambda: ref.masked_sum_counts(
                x, slot, band, C, S), 2),
            # owned lanes (2 B) read, band read, x_bar written, slot read
            "bound_ms": bound_ms(2 * owned + 4 * (2 * d + N)),
            "sector_floor_ms": bound_ms(32 * sectors + 4 * (2 * d + N)),
        }))
        del x
    del band

    # -- masked_sum over f16 lanes at the width of [wire]'s f16 group -------
    # (the auto policy's small leaves; the width the path runs)
    gdims = [D for D in spec.dims if wire.resolve_kind(D, "auto") == "f16"]
    dg = sum(gdims)
    band = comm_ws.cyclic_band(gdims, C, S, dev)
    x = torch.randn(N, dg, generator=g, device=dev).half()
    x[1] = float("nan")
    got = uplink.masked_sum(x, slot, band, C, S)
    want = ref.masked_sum(x, slot, band, C, S)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"masked_sum f16 lanes at [wire]'s group width "
                             f"{dg}: max abs err {err}")
    f16 = next(r for r in recs if r["name"] == "masked_sum_f16")
    f16.update({
        "wire_shape": [N, dg], "wire_max_abs_err": err,
        "wire_ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S),
                           200),
        "wire_plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S),
                                 20),
        "wire_bound_ms": bound_ms(2 * owned_entries(slot, band, C, S)
                                  + 4 * (2 * dg + N)),
    })
    print(f"[check] masked_sum_f16 at [wire]'s f16 group ({len(gdims)} "
          f"leaves, {dg} columns): {f16['wire_ms']:.4f} ms, plain "
          f"{f16['wire_plain_ms']:.4f} ms, bound {f16['wire_bound_ms']:.4f} "
          f"ms")
    del x, got, want, band

    # -- wire_quantize: int8, int4 (UpCom) and the DownCom -----------------
    x = torch.randn(N, d, generator=g, device=dev)
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, 7::999_983] = float("nan")
    x[1, 256:512] = 0.0  # an all-zero chunk of the first leaf
    q = {}
    for kind in ("int8", "int4"):
        codes, scales = wire_pack.pack_int(x, leaves, kind, 0x5EED)
        codes_p, scales_p = ref.wire_pack(x, leaves, kind, 0x5EED)
        torch.cuda.synchronize()
        err = max(max_abs_err(codes, codes_p),
                  max_abs_err(scales, scales_p))
        n_bad = int(scales.isnan().sum())
        if err != 0.0 or n_bad == 0:
            raise AssertionError(f"wire_quantize {kind}: max abs err {err}, "
                                 f"{n_bad} poisoned chunks")
        del codes_p, scales_p
        # a rank's rows: rows 2-3 packed alone with row0 = 2 are those
        # rows of the whole pack, and the plain version's with that row0
        codes_r, scales_r = wire_pack.pack_int(x[2:], leaves, kind, 0x5EED,
                                               row0=2)
        codes_p, scales_p = ref.wire_pack(x[2:], leaves, kind, 0x5EED, 2)
        torch.cuda.synchronize()
        err_r = max(max_abs_err(codes_r, codes_p),
                    max_abs_err(scales_r, scales_p))
        same_r = (torch.equal(codes_r, codes[2:])
                  and torch.equal(scales_r.view(torch.int32),
                                  scales[2:].view(torch.int32)))
        print(f"[check] wire_quantize {kind} with row0 = 2 on rows 2-3: max "
              f"abs err {err_r} against the plain version, the whole "
              f"pack's rows 2-3 bitwise {same_r}")
        if err_r != 0.0 or not same_r:
            raise AssertionError(f"wire_quantize {kind} row0: max abs err "
                                 f"{err_r}, whole pack's rows {same_r}")
        err = max(err, err_r)
        del codes, scales, codes_p, scales_p, codes_r, scales_r
        q[kind] = (err, cuda_ms(lambda: wire_pack.pack_int(
            x, leaves, kind, 0x5EED), 5), cuda_ms(lambda: ref.wire_pack(
                x, leaves, kind, 0x5EED), 2), n_bad)
    row = x[0].clone()
    row[3::1000] = float("nan")
    row[512:768] = 0.0  # an all-zero chunk
    got, want = row.clone(), row.clone()
    wire_pack.quantize_down(got, leaves, "int8", 0x5EED)
    ref.wire_down(want, leaves, "int8", 0x5EED)
    torch.cuda.synchronize()
    err_down = max_abs_err(got, want)
    if err_down != 0.0 or not bool(torch.equal(got.isinf(), row.isinf())):
        raise AssertionError(f"wire_quantize DownCom: max abs err "
                             f"{err_down}")
    down_ms = cuda_ms(lambda: wire_pack.quantize_down(
        got, leaves, "int8", 0x5EED), 5)
    down_plain_ms = cuda_ms(lambda: ref.wire_down(
        want, leaves, "int8", 0x5EED), 2)
    del got, want, row, x
    print(f"[check] wire_quantize: {q['int8'][3]} (int8) and {q['int4'][3]} "
          f"(int4) NaN-poisoned chunk scales of {N * nc}")
    # x read, the codes and the scales written, the leaf tables read
    up_bound = bound_ms(5 * N * d + 4 * N * nc + 40 * len(leaves))
    # the DownCom: x_bar read and written in place, the leaf tables read
    down_bound = bound_ms(8 * d + 40 * len(leaves))
    for form, ms, bound in (("int8", q["int8"][1], up_bound),
                            ("int4", q["int4"][1], up_bound),
                            ("DownCom", down_ms, down_bound)):
        print(f"[check] wire_quantize {form}: {ms:.3f} ms, "
              f"{bound / ms:.1%} of the bound ({bound:.3f} ms)")
    recs.append({
        "name": "wire_quantize", "shape": [N, d],
        "max_abs_err": max(q["int8"][0], q["int4"][0], err_down),
        "tolerance": 0.0,
        # the [wire] paths' UpCom form, int8; int4 and the DownCom ride
        # along
        "ms": q["int8"][1], "plain_ms": q["int8"][2],
        "int4_ms": q["int4"][1], "int4_plain_ms": q["int4"][2],
        "down_ms": down_ms, "down_plain_ms": down_plain_ms,
        "bound_ms": up_bound, "down_bound_ms": down_bound,
    })
    return recs


def check_reduced_wire_round(dev, uplink="masked_psum"):
    """One reduced-config round on the int8 wire with the DownCom
    quantized, a dropped member and (cyclic template) the trimmed mean:
    the local steps on the card against the CPU (1e-5), then the comm step
    on both devices from the CPU's trained state, which must agree bitwise
    (a last-bit difference in a trained coordinate may move its stochastic
    rounding by a level, so the two steps are held apart).  ``uplink=
    "block_rs"`` runs the blocked template's step with the mean."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    cfg = gemma2_2b.REDUCED
    n, cohort = NF, [0, 1, 3, 4]
    blocked = uplink == "block_rs"
    tmpl = dict(off=1) if blocked else dict(perm=[3, 0, 2, 1])
    tcfg = tamuna_dp.DistTamunaConfig(
        gamma=GAMMA, c=CF, s=SF, p=P, wire_precision="int8", wire_down=True,
        uplink=uplink, robust_agg="mean" if blocked else "trimmed",
        trim_k=0 if blocked else 1)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, CF, 2, 97)))
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, d_total)).astype(np.float32))
    trained = {}
    for device in ("cpu", dev):
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
        state.x[1:] += noise
        state.x, state.h = state.x.to(device), state.h.to(device)
        local = tamuna_dp.make_local_step(cfg, tcfg)
        compact = tamuna_dp.gather_cohort(state, cohort)
        for t in range(toks.shape[0]):
            tk = toks[t].to(device)
            local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
        trained[str(device)] = state
    x_cpu = trained["cpu"].x.clone()
    err_local = max_abs_err(x_cpu, trained[str(dev)].x.cpu())
    out = {}
    for device in ("cpu", dev):
        state = trained[str(device)]
        state.x = x_cpu.clone().to(device)  # the step works in place
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(state, cohort, down=[True, True, True, False, True],
                     arrived=np.array([True, False, False, True, True]),
                     wire_seed=0xC0FFEE, **tmpl)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err_comm = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    print(f"[reduced] one int8 wire_down round of {cfg.name} (n={n} c={CF} "
          f"s={SF} {uplink} {tcfg.robust_agg}, member 1 dropped): local "
          f"steps card vs CPU "
          f"max abs err {err_local:.3e} (tolerance 1e-5), comm step from the "
          f"same trained state {err_comm} (tolerance 0)")
    if not err_local <= 1e-5 or err_comm != 0.0:
        raise AssertionError(f"reduced wire round: local {err_local}, comm "
                             f"{err_comm}")


def reduced_round_inputs(n: int, c: int, arch: str = "gemma2-2b",
                         seq: int = None, batch: int = 2, steps: int = 2):
    """The reduced config of ``arch``, the round's batches ``(steps, c,
    batch, seq + 1)`` (``seq`` 96, or REDUCED_SEQ's) and the noise that
    makes the ``n - 1`` other client rows distinct, the same on every
    side."""
    from repro_torch.configs import registry
    from repro_torch.dist import comm_ws, model_api

    cfg = registry.get_reduced_config(arch)
    seq = seq or REDUCED_SEQ.get(arch, 96)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         size=(steps, c, batch, seq + 1)))
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, d_total)).astype(np.float32))
    return cfg, toks, noise


def reduced_frames(cfg, c: int):
    """The encoder-decoder's frames for ``reduced_round_inputs``' two steps,
    ``(2, c, 2, n_frames, d_model)`` f32 (``None`` for the other
    families)."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(6)
    return torch.from_numpy(rng.normal(
        size=(2, c, 2, cfg.n_frames, cfg.d_model)).astype(np.float32))


def reduced_local(device, cfg, tcfg, n, cohort, toks, noise, frames=None):
    """The round's state after its two local steps on ``device`` (with
    ``frames``, ``reduced_frames``', for the encoder-decoder), and the
    cohort's rows."""
    from repro_torch.dist import tamuna_dp

    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state.x[1:] += noise
    state.x, state.h = state.x.to(device), state.h.to(device)
    if tcfg.local_opt == "adamw":
        state.opt = state.opt._replace(mu=state.opt.mu.to(device),
                                       nu=state.opt.nu.to(device))
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, cohort)
    for t in range(toks.shape[0]):
        tk = toks[t].to(device)
        kw = {} if frames is None else {"frames": frames[t].to(device)}
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:], **kw)
    return state, compact


class intra_op_threads:
    """``torch.set_num_threads(k)`` inside the block (``None`` keeps the
    current count)."""

    def __init__(self, k):
        self.k = k

    def __enter__(self):
        self.prev = torch.get_num_threads()
        if self.k is not None:
            torch.set_num_threads(self.k)

    def __exit__(self, *exc):
        torch.set_num_threads(self.prev)


def reduced_round_err(dev, n, c, s, cohort, perm, down, arrived=None,
                      **robust):
    """One reduced-config round on the card and on the CPU (plain
    versions) with the same schedule, batches and (if given) arrived rows
    injected: ``(max abs err over x and h, where the worst coordinate
    lies)``.  Under ``uplink="block_rs"`` ``perm`` is the round's shift
    ``off``."""
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **robust)
    cfg, toks, noise = reduced_round_inputs(n, c)
    down = torch.tensor(down)
    kw = {} if arrived is None else {"arrived": np.asarray(arrived)}
    if tcfg.uplink == "block_rs":
        kw["off"], perm = perm, None
    out = {}
    for device in ("cpu", dev):
        state, compact = reduced_local(device, cfg, tcfg, n, cohort, toks,
                                       noise)
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), cohort, perm,
                     down, **kw)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    where = []
    for tag, a, b in (("x", xc, xg), ("h", hc, hg)):
        row, k = divmod(int((a - b).abs().argmax()), spec.d_total)
        leaf = max(i for i, o in enumerate(spec.offsets) if o <= k)
        where.append(f"{tag}[{row}] {spec.names[leaf]}"
                     f"[{k - spec.offsets[leaf]}]: CPU "
                     f"{float(a[row, k])!r}, card {float(b[row, k])!r}")
    return err, "; ".join(where)


def check_reduced_round(dev, n, c, s, cohort, perm, down, arrived=None,
                        **robust):
    """One reduced-config round on the card against the same round on the
    CPU (plain versions), gated at 1e-5."""
    err, where = reduced_round_err(dev, n, c, s, cohort, perm, down,
                                   arrived, **robust)
    print(f"[reduced] one round of gemma2-2b-reduced (n={n} c={c} s={s} "
          f"{robust.get('uplink', 'masked_psum')} "
          f"{robust.get('robust_agg', 'mean')}, arrived {arrived}) on the "
          f"card vs the CPU: max abs err {err:.3e} (tolerance 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"reduced round: card vs CPU err {err}; "
                             + where)


def check_reduced_family_round(dev, arch: str, seq: int = None,
                               batch: int = 2, steps: int = 2,
                               f64_threads=None) -> None:
    """One fault-free round of ``arch``'s reduced config (n=4, c=3, s=2;
    ``seq`` tokens, ``batch`` sequences per client, ``steps`` local steps:
    at REDUCED_LONG_SEQ gemma2-2b's round runs the blockwise attention
    under ``remat``; the float64 round on ``f64_threads`` intra-op
    threads, the caller's when ``None``)
    on the card, on the CPU and on the CPU in float64 compute (each
    gradient rounded to the f32 leaf; the same schedule, batches, frames
    for the encoder-decoder, and noise), gated leaf by leaf in x and in h: the card within
    ``max(1e-5, F64_RATIO * CPU)`` of the float64 round, where CPU is that
    leaf's CPU distance from it.  The new families' f32 rounds lie 2e-5
    to 1e-4 from the float64 round at these sizes (their embeddings'
    gradients reach 3-5 and RWKV's and Mamba2's scans carry e^20-e^60
    factors); the card's f32 products accumulate in other orders, so its
    distance differs from the CPU's, and card against CPU, printed
    beside, is of that order and not held to gemma2-2b's 1e-5.  A leaf
    the CPU rounds within 1e-5 of float64 keeps that 1e-5 on the card.
    The round's kernels must have launched on the card.  For the MoE
    configs, the routing choices (each token's set of top-k experts, at
    every router call) of the three rounds are compared and the tokens
    routed differently counted."""
    from repro_torch.dist import tamuna_dp
    from repro_torch.kernels import _build
    from repro_torch.models import moe

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    cfg, toks, noise = reduced_round_inputs(N, C, arch, seq, batch, steps)
    frames = reduced_frames(cfg, C)
    spec = tamuna_dp.state_spec(cfg, tcfg)
    down = torch.tensor([True, True, False, True])
    top_k = moe.top_k
    out, routes = {}, {}
    for tag, device, dt in (("cpu", "cpu", None), ("card", dev, None),
                            ("f64", "cpu", torch.float64)):
        c = cfg if dt is None else dataclasses.replace(cfg, dtype=dt)
        routes[tag] = []

        def recorded(probs, k, seen=routes[tag]):
            vals, idx = top_k(probs, k)
            seen.append(idx.sort(dim=-1).values.cpu())
            return vals, idx

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        moe.top_k = recorded
        try:
            with intra_op_threads(f64_threads if tag == "f64" else None):
                state, compact = reduced_local(device, c, tcfg, N,
                                               [0, 2, 3], toks, noise, frames)
        finally:
            moe.top_k = top_k
        comm = tamuna_dp.make_comm_step(c, tcfg, N, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), [0, 2, 3],
                     [2, 0, 1], down)
        out[tag] = (state.x.cpu(), state.h.cpu())
        if tag == "card":
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.launch_counts.items() if v}

    def err(a, b, i, cols=slice(None)):
        return max_abs_err(out[a][i][:, cols], out[b][i][:, cols])

    card_cpu = max(err("card", "cpu", i) for i in (0, 1))
    cpu_f64 = max(err("cpu", "f64", i) for i in (0, 1))
    card_f64 = max(err("card", "f64", i) for i in (0, 1))
    worst, bad, floored = (0.0, ""), [], 0
    for i, which in ((0, "x"), (1, "h")):
        for name, off, d in zip(spec.names, spec.offsets, spec.dims):
            cols = slice(off, off + d)
            cpu_l, card_l = err("cpu", "f64", i, cols), err("card", "f64", i,
                                                            cols)
            limit = max(1e-5, F64_RATIO * cpu_l)
            floored += limit == 1e-5
            row = (f"{which}:{name} card {card_l:.3e} CPU {cpu_l:.3e} "
                   f"card-vs-CPU {err('card', 'cpu', i, cols):.3e}")
            if card_l / limit >= worst[0]:
                worst = (card_l / limit, row)
            if not card_l <= limit:
                bad.append(row)
    print(f"[reduced] one round of {cfg.name} (n={N} c={C} s={S}, "
          f"{toks.shape[-1] - 1} tokens, {toks.shape[2]} sequences per "
          f"client, remat {cfg.remat}): card vs CPU {card_cpu:.3e}; "
          f"against the float64 round: CPU {cpu_f64:.3e}, card "
          f"{card_f64:.3e}; leaf by leaf ({2 * len(spec.names)} leaves of x "
          f"and h, {floored} at the 1e-5 floor) the closest to its limit "
          f"max(1e-5, {F64_RATIO} CPU) is {worst[1]} ({worst[0]:.2f} of "
          f"it); launches {launches}")
    if routes["cpu"]:
        flips = {f"{a} vs {b}": sum(int((ra != rb).any(-1).sum())
                                    for ra, rb in zip(routes[a], routes[b]))
                 for a, b in (("card", "cpu"), ("cpu", "f64"),
                              ("card", "f64"))}
        tokens = sum(int(r[..., 0].numel()) for r in routes["cpu"])
        print(f"[reduced] {cfg.name}: tokens routed to another set of "
              f"experts, over {len(routes['cpu'])} router calls and {tokens} "
              f"token routings: {flips}")
    need = ("masked_sum", "h_update", "fused_local_step")
    if bad or not all(launches.get(k) for k in need):
        raise AssertionError(f"reduced round of {arch}: leaves over their "
                             f"limit {bad}; launches {launches}")


def check_reduced_adamw_round(dev):
    """One reduced-config AdamW round with microbatches=2 on the card
    against the CPU: one local step (each member's batch of 2 in two
    microbatches), then the comm step.  AdamW's first step is ``(g - h) /
    (|g - h| + eps)``: where ``g - h`` lies within ADAM_NEAR0 of 0 in a
    cohort row (from the CPU's first moment) the card's and the CPU's
    gradient roundings may step x apart by up to 2 gamma, and x_bar and the
    owners' h carry that on; those columns are held to that bound and
    counted, every other coordinate (x, h, mu, nu) to 1e-5."""
    from repro_torch.dist import tamuna_dp

    n, c, s = N, C, S
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P,
                                      local_opt="adamw", microbatches=2)
    scale = tcfg.eta_(n) / GAMMA
    cfg, toks, noise = reduced_round_inputs(n, c)
    cohort, perm, down = [0, 2, 3], [2, 0, 1], torch.tensor(
        [True, True, False, True])
    out = {}
    for device in ("cpu", dev):
        state, compact = reduced_local(device, cfg, tcfg, n, cohort,
                                       toks[:1], noise)
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), cohort, perm,
                     down)
        out[str(device)] = [t.cpu() for t in (state.x, state.h, state.opt.mu,
                                              state.opt.nu)]
        assert state.opt.count == 1
    cpu, card = out["cpu"], out[str(dev)]
    # |g - h| = |mu| / (1 - b1) after one step, per column over the cohort
    near = (cpu[2][cohort].abs() <= 0.1 * ADAM_NEAR0).any(dim=0)
    errs, near_errs = [], []
    for a, b in zip(cpu, card):
        diff = (a - b).abs()
        errs.append(float(diff[:, ~near].max()))
        near_errs.append(float(diff[:, near].max()) if near.any() else 0.0)
    # an AdamW step moves x by at most gamma (1 + a few ulp); 1e-5 covers
    # those ulp and x's own rounding
    bounds = (2 * GAMMA + 1e-5, 4 * GAMMA * scale + 1e-5, 1e-5, 1e-5)
    print(f"[reduced] one AdamW round (microbatches=2, one local step) of "
          f"{cfg.name} (n={n} c={c} s={s}) on the card vs the CPU: max abs "
          f"err x {errs[0]:.3e} h {errs[1]:.3e} mu {errs[2]:.3e} nu "
          f"{errs[3]:.3e} (tolerance 1e-5) off the {int(near.sum())} of "
          f"{near.numel()} columns where |g - h| <= {ADAM_NEAR0} in a cohort "
          f"row; there x {near_errs[0]:.3e} h {near_errs[1]:.3e} (bounds "
          f"{bounds[0]:.3g}, {bounds[1]:.3g})")
    if not (max(errs) <= 1e-5 and all(e <= b for e, b in
                                      zip(near_errs, bounds))):
        raise AssertionError(f"reduced AdamW round: {errs} {near_errs}")


def check_tall_round(dev):
    """One round of a dense model of one layer and width 16 at n = c = 40,
    s = 2 on the card against the CPU (1e-5): its norm leaves (D = 16, D s
    = 32 < c) are laid last and take the dense per-leaf fallback, the other
    leaves stay on the kernels (which run over the columns before them
    with the workspace's row pitch)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, tamuna_dp

    cfg = dataclasses.replace(gemma2_2b.REDUCED, name="dense-1x16",
                              **TINY_TALL)
    n, c, s = TALL["n"], TALL["c"], TALL["s"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P)
    spec = tamuna_dp.state_spec(cfg, tcfg)
    tall = spec.names[spec.n_main:]
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, n, 2, 33)))
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, spec.d_total)).astype(np.float32))
    perm = rng.permutation(c).tolist()
    down = torch.from_numpy(rng.random(n) < 0.7)
    out = {}
    for device in ("cpu", dev):
        state, compact = reduced_local(device, cfg, tcfg, n, list(range(n)),
                                       toks, noise)
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact),
                     list(range(n)), perm, down)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    print(f"[reduced] one round of {cfg.name} (n={n} c={c} s={s}; "
          f"{len(tall)} tall leaves {list(tall)} of {len(spec.names)} laid "
          f"last, the kernels over {spec.d_main} of {spec.d_total} columns) "
          f"on the card vs the CPU: max abs err {err:.3e} (tolerance 1e-5)")
    if not tall or not err <= 1e-5:
        raise AssertionError(f"tall round: {len(tall)} tall leaves, err "
                             f"{err}")


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in units of one bf16 ulp of the larger of |a| and |b|
    (magnitudes below 2^-10 count as 2^-10, where f32 rounding of a sum of
    O(1) terms is still far below one ulp)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def attn_bound(b, h, kvh, hd, n_keys, q_bytes, kv_bytes):
    """``(bound ms, "bytes" | "operations")`` of one decode attention: the
    visible K and V rows read once, q read, the output written; the
    logits and the weighted sum, 4 b h n_keys hd operations, at the
    card's rate for the inputs' type (bf16 tensor cores, else f32)."""
    nbytes = 2 * b * kvh * n_keys * hd * kv_bytes + 2 * b * h * hd * q_bytes
    ops = 4 * b * h * n_keys * hd
    peak = BF16_OPS_PER_S if max(q_bytes, kv_bytes) == 2 else F32_OPS_PER_S
    t_bytes, t_ops = bound_ms(nbytes), ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_call(q, k, v, pos: int, window):
    """``scaled_dot_product_attention`` with ``enable_gqa`` on the same
    inputs, the cache in its layout ``(b, kvh, S, hd)`` and the window as
    a boolean mask, softcap off (no PyTorch call applies one): the
    library's time for the same function without the softcap.  The
    library takes one dtype, so a bf16 cache under f32 queries is widened
    first (outside the timed call)."""
    import torch.nn.functional as F

    S = k.shape[1]
    qs = q[:, :, None, :]
    ks, vs = (t.transpose(1, 2).to(q.dtype).contiguous() for t in (k, v))
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    mask = mask[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True)


def check_decode_case(q, k, v, pos, window, softcap, reps, plain_reps,
                      tol_ulps=None, tol_abs=None, library=False):
    """The decode kernel against its plain version on one case, both
    timed; the error in bf16 ulps (``tol_ulps``) or absolute
    (``tol_abs``)."""
    from repro_torch.kernels import decode_attn, ref

    b, h, hd = q.shape
    kvh = k.shape[2]
    got = decode_attn.decode_attention(q, k, v, pos, window=window,
                                       softcap=softcap)
    want = ref.decode_attention(q, k, v, pos, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    err = max_abs_err(got.float(), want.float())
    ulps = bf16_ulps(got, want)
    del got, want
    bad = (tol_ulps is not None and not ulps <= tol_ulps) or (
        tol_abs is not None and not err <= tol_abs)
    wtag = "global" if window is None or window > k.shape[1] else window
    if bad:
        raise AssertionError(
            f"decode_attention {list(q.shape)} {q.dtype} on {k.dtype} cache "
            f"pos {pos} window {wtag}: max abs err {err}, {ulps} bf16 ulps")
    _, n_keys = decode_attn.visible_keys(pos, window)
    bound, by = attn_bound(b, h, kvh, hd, n_keys, q.element_size(),
                           k.element_size())
    rec = {
        "pos": pos, "window": wtag, "softcap": softcap,
        "max_abs_err": err, "bf16_ulps": ulps,
        "ms": cuda_ms(lambda: decode_attn.decode_attention(
            q, k, v, pos, window=window, softcap=softcap), reps),
        "plain_ms": cuda_ms(lambda: ref.decode_attention(
            q, k, v, pos, window=window, softcap=softcap), plain_reps),
        "bound_ms": bound, "bound_by": by,
        "splits": decode_attn.split_plan(
            b, kvh, n_keys, tiled=q.dtype == torch.bfloat16)[0],
    }
    if library:
        fn = sdpa_call(q, k, v, pos, window)
        lib = fn()[:, :, 0]
        nocap = ref.decode_attention(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        rec["library_max_abs_err_softcap_off"] = max_abs_err(
            lib.float(), nocap.float())
        del lib, nocap
        rec["library_ms"] = cuda_ms(fn, reps)
    return rec


def print_decode_case(name, c, shape, tol) -> None:
    """One ``check_decode_case`` record as a ``[decode]`` line; ``shape``
    is ``(b, S, h, kvh, hd)``."""
    b, S, h, kvh, hd = shape
    print(f"[decode] {name} {[b, h, hd]} on ({b}, {S}, {kvh}, {hd}) "
          f"pos {c['pos']} window {c['window']} softcap "
          f"{c['softcap']}: max abs err {c['max_abs_err']:.3e} "
          f"({c['bf16_ulps']:.3f} bf16 ulps; tolerance "
          f"{tol}), {c['ms']:.5f} ms vs plain {c['plain_ms']:.5f} "
          f"ms, library {c.get('library_ms', math.nan):.5f} ms "
          f"(softcap off, err vs plain without softcap "
          f"{c.get('library_max_abs_err_softcap_off', math.nan):.3e}"
          f"), bound {c['bound_ms']:.5f} ms ({c['bound_by']}; "
          f"{c['bound_ms'] / c['ms']:.1%} of it), kernel over "
          f"library {c['ms'] / c.get('library_ms', math.nan):.3f}"
          f"x, {c['splits']} splits")


def check_decode_kernels(dev):
    """``decode_attention`` against its plain version on the card: bf16
    queries and cache at gemma2-2b's attention (h 8, kvh 4, hd 256) over a
    32k cache, ``pos`` in {0, 4095, 30000} x window in {4096, global},
    softcap 50, within one bf16 ulp; f32 queries on f32 and bf16 caches at
    the reduced config's heads within 2e-5.  One case also poisons every
    cache row outside the visible keys with NaN: the kernel never reads
    them.  Returns one record per instantiation, the headline case first
    in ``cases``."""
    from repro_torch.kernels import decode_attn
    from repro_torch.models.transformer import GLOBAL_WINDOW

    g = torch.Generator(device=dev).manual_seed(8)
    recs = []
    cfgs = (
        ("decode_attention", DECODE_FULL, torch.bfloat16, torch.bfloat16,
         (30000, 4095, 0), 4096),
        ("decode_attention_f32", DECODE_F32, torch.float32, torch.float32,
         (4095, 1000, 0), 64),
        ("decode_attention_f32_bf16kv", DECODE_F32, torch.float32,
         torch.bfloat16, (4095, 1000, 0), 64),
    )
    for name, shp, qt, kvt, positions, local in cfgs:
        b, h, kvh, hd, S = (shp[x] for x in ("b", "h", "kvh", "hd", "S"))
        q = torch.randn(b, h, hd, generator=g, device=dev).to(qt)
        k = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        v = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        full = name == "decode_attention"
        tol = dict(tol_ulps=1.0) if qt == torch.bfloat16 else dict(
            tol_abs=2e-5)
        cases = []
        for pos in positions:
            for window in (GLOBAL_WINDOW, local):
                cases.append(check_decode_case(
                    q, k, v, pos, window, 50.0, 20 if full else 50,
                    3 if full else 10, library=True, **tol))
        # no softcap, and the NaN-poisoned rows outside [lo, pos]
        cases.append(check_decode_case(q, k, v, positions[1], local, None,
                                       20, 3, **tol))
        path_cases = []
        if full:
            # the serving paths' shapes: [serve]'s last step (8 x 512 rows)
            # and [serve_long]'s (4 x 4608 rows, local and global layer)
            long_rows = SERVE_LONG["prompt_len"] + SERVE_LONG["gen_len"]
            for bb, rows, window in (
                    (SERVE["batch"], SERVE["prompt_len"] + SERVE["gen_len"],
                     GLOBAL_WINDOW),
                    (SERVE_LONG["batch"], long_rows, GLOBAL_WINDOW),
                    (SERVE_LONG["batch"], long_rows, local)):
                ks, vs = (t[:bb, :rows].contiguous() for t in (k, v))
                path_cases.append(check_decode_case(
                    q[:bb].contiguous(), ks, vs, rows - 1, window, 50.0, 50,
                    10, library=True, **tol))
                path_cases[-1]["cache"] = [bb, rows, kvh, hd]
                del ks, vs
        pos = positions[1]
        lo, _ = decode_attn.visible_keys(pos, local)
        clean = decode_attn.decode_attention(q, k, v, pos, window=local,
                                             softcap=50.0)
        kp, vp = k.clone(), v.clone()
        for t in (kp, vp):
            t[:, :lo] = float("nan")
            t[:, pos + 1:] = float("nan")
        poisoned = decode_attn.decode_attention(q, kp, vp, pos,
                                                window=local, softcap=50.0)
        torch.cuda.synchronize()
        if not torch.equal(clean, poisoned):
            raise AssertionError(f"{name}: a row outside the visible keys "
                                 "reached the output")
        del kp, vp, clean, poisoned, q, k, v
        torch.cuda.empty_cache()
        head = cases[0]
        for c in cases + path_cases:
            cb, cs = c.get("cache", [b, S])[:2]
            print_decode_case(name, c, (cb, cs, h, kvh, hd), tol)
        print(f"[decode] {name}: cache rows outside the visible keys "
              "poisoned with NaN: output unchanged, bitwise")
        recs.append({
            "name": name, "shape": [[b, h, hd], [b, S, kvh, hd]],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": (f"{tol['tol_ulps']} bf16 ulp" if "tol_ulps" in tol
                          else tol["tol_abs"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "scaled_dot_product_attention(enable_gqa=True), "
                       "softcap off: no PyTorch call applies a softcap",
            "headline": f"pos {head['pos']} window {head['window']}",
            "cases": cases, "path_cases": path_cases,
        })
    return recs


def check_decode_hd80(dev):
    """``decode_attention`` at head_dim 80 (stablelm-3b) against its plain
    version, all three instantiations, at DECODE_HD80: the headline pos
    4095 globally without softcap (stablelm-3b's own attention, which SDPA
    computes exactly), a 1024 window, the first tile's edge (pos 15), a
    split's edge (pos = split_len) in a window of 41 off the tile grid, and
    softcap 50 at pos 2047; bf16 within one bf16 ulp, f32 within 2e-5.
    Returns one record per instantiation, its launches counted under the
    instantiation's own name (``count``)."""
    from repro_torch.kernels import decode_attn
    from repro_torch.models.transformer import GLOBAL_WINDOW

    g = torch.Generator(device=dev).manual_seed(80)
    shp = DECODE_HD80
    b, h, kvh, hd, S = (shp[x] for x in ("b", "h", "kvh", "hd", "S"))
    recs = []
    for count, qt, kvt in (
            ("decode_attention", torch.bfloat16, torch.bfloat16),
            ("decode_attention_f32", torch.float32, torch.float32),
            ("decode_attention_f32_bf16kv", torch.float32, torch.bfloat16)):
        q = torch.randn(b, h, hd, generator=g, device=dev).to(qt)
        k = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        v = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        tol = dict(tol_ulps=1.0) if qt == torch.bfloat16 else dict(
            tol_abs=2e-5)
        _, split_len = decode_attn.split_plan(
            b, kvh, S, tiled=qt == torch.bfloat16)
        cases = [check_decode_case(q, k, v, pos, window, cap, reps, plain,
                                   library=lib, **tol)
                 for pos, window, cap, reps, plain, lib in (
                     (S - 1, GLOBAL_WINDOW, None, 50, 5, True),
                     (S - 1, 1024, None, 50, 5, True),
                     (decode_attn.TILE - 1, GLOBAL_WINDOW, None, 20, 3,
                      False),
                     (min(split_len, S - 1), 41, None, 20, 3, False),
                     (S // 2 - 1, GLOBAL_WINDOW, 50.0, 20, 3, False))]
        del q, k, v
        torch.cuda.empty_cache()
        name = f"{count}_hd80"
        for c in cases:
            print_decode_case(name, c, (b, S, h, kvh, hd), tol)
        head = cases[0]
        recs.append({
            "name": name, "count": count,
            "shape": [[b, h, hd], [b, S, kvh, hd]],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": (f"{tol['tol_ulps']} bf16 ulp" if "tol_ulps" in tol
                          else tol["tol_abs"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "scaled_dot_product_attention(enable_gqa=True): the "
                       "same function at the headline (no softcap, global)",
            "headline": f"pos {head['pos']} window {head['window']}",
            "cases": cases,
        })
    return recs


def check_decode_hd128(dev):
    """``decode_attention`` (bf16, the instantiation the serving paths
    launch) at head_dim 128 against its plain version within one bf16
    ulp: at ``[serve_moe]``'s heads (qwen2-moe-a2.7b: 16 heads, group 1)
    over DECODE_HD128's 4096-key cache, the headline pos 4095 globally
    without softcap (the model's own attention, which SDPA computes
    exactly), a 1024 window, the first tile's edge and a split's edge in a
    window of 41; and at qwen3-moe's group 8 (32 heads on 4 kv heads,
    DECODE_HD128_G8) globally.  Returns one record, its launches counted
    under ``decode_attention``."""
    from repro_torch.kernels import decode_attn
    from repro_torch.models.transformer import GLOBAL_WINDOW

    g = torch.Generator(device=dev).manual_seed(128)
    cases = []
    for shp, heads in ((DECODE_HD128, True), (DECODE_HD128_G8, False)):
        b, h, kvh, hd, S = (shp[x] for x in ("b", "h", "kvh", "hd", "S"))
        q = torch.randn(b, h, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(b, S, kvh, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(b, S, kvh, hd, generator=g, device=dev).bfloat16()
        _, split_len = decode_attn.split_plan(b, kvh, S, tiled=True)
        todo = [(S - 1, GLOBAL_WINDOW, 50, 5, True)]
        if heads:
            todo += [(S - 1, 1024, 50, 5, True),
                     (decode_attn.TILE - 1, GLOBAL_WINDOW, 20, 3, False),
                     (min(split_len, S - 1), 41, 20, 3, False)]
        for pos, window, reps, plain, lib in todo:
            c = check_decode_case(q, k, v, pos, window, None, reps, plain,
                                  tol_ulps=1.0, library=lib)
            c["cache"] = [b, S, kvh, hd]
            c["heads"] = h
            cases.append(c)
            print_decode_case("decode_attention_hd128", c, (b, S, h, kvh, hd),
                              dict(tol_ulps=1.0))
        del q, k, v
        torch.cuda.empty_cache()
    head = cases[0]
    b, h, kvh, hd, S = (DECODE_HD128[x] for x in ("b", "h", "kvh", "hd", "S"))
    return [{
        "name": "decode_attention_hd128", "count": "decode_attention",
        "shape": [[b, h, hd], [b, S, kvh, hd]],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": "1.0 bf16 ulp",
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library": "scaled_dot_product_attention(enable_gqa=True): the same "
                   "function at the headline (no softcap, global)",
        "headline": f"pos {head['pos']} window {head['window']}",
        "cases": cases,
    }]


def compress_owned(slot, d: int, c: int, s: int) -> int:
    """How many (row, coordinate) pairs the slots own under the cyclic
    template: the x entries ``compress`` must read."""
    r = np.arange(c)
    per_r = d // c + (r < d % c)  # coordinates k with k mod c = r
    band = (-(s * r)) % c
    return int(sum(per_r[(sl + band) % c < s].sum()
                   for sl in np.asarray(slot).tolist() if 0 <= sl < c))


def check_compress(x, slot, c: int, s: int, reps: int,
                   plain_reps: int) -> dict:
    """``compress`` against its plain version on ``x`` (bitwise), both
    timed; returns the measurements."""
    from repro_torch.kernels import compress, ref

    got = compress.compress(x, slot, c, s)
    want = ref.compress(x, slot, c, s)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    del got, want
    n = 1 if x.dim() == 1 else x.shape[0]
    name = (f"compress{'_1d' if x.dim() == 1 else ''}_"
            f"{'f64' if x.dtype == torch.float64 else 'f32'}")
    if err != 0.0:
        raise AssertionError(f"{name} {list(x.shape)}: max abs err {err}, "
                             "want 0")
    owned = compress_owned(slot.cpu(), x.shape[-1], c, s)
    return {
        "name": name, "shape": list(x.shape), "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: compress.compress(x, slot, c, s), reps),
        "plain_ms": cuda_ms(lambda: ref.compress(x, slot, c, s),
                            plain_reps),
        # owned x entries read, every output written, slot read
        "bound_ms": bound_ms(x.element_size() * (owned + x.numel())
                             + 4 * n),
    }


def check_compress_kernels(d_total, dev):
    """``compress`` in both ranks and types against its plain version: f64
    at the convex paths' shapes and round-0 permutations, f32 on the comm
    workspace of the LM paths (slot ``[1, -1, 0, 2]``, c=3, s=2, an idle
    row of NaN) and its one-row form; returns one record per
    instantiation."""
    from repro_torch.core import masks, theory
    from repro_torch.kernels import compress

    g = torch.Generator(device=dev).manual_seed(7)
    d = CONVEX["d"]
    recs = {}
    for c, reps in ((100, 200), (1000, 100)):
        s = theory.recommended_s(c, d, 0.0)
        perm = torch.from_numpy(masks.sample_permutation(0, 0, c)).to(
            device=dev, dtype=torch.int32)
        x = torch.randn(c, d, generator=g, device=dev, dtype=torch.float64)
        rec = check_compress(x, perm, c, s, reps, 20)
        # the kernel body's own time, without the wrapper's host time
        rec["kernel_ms"], rec["kernel_ms_by"] = kernel_only_ms(
            lambda: compress.compress(x, perm, c, s), "compress_kernel")
        # the wrapper's host time: calls issued without a synchronisation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            compress.compress(x, perm, c, s)
        rec["host_ms"] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        print(f"[check] compress_f64 {[c, d]}: kernel only "
              f"{rec['kernel_ms']:.4f} ms ({rec['kernel_ms_by']}), per call "
              f"{rec['ms']:.4f} ms, the wrapper's host time "
              f"{rec['host_ms']:.4f} ms per call, bound "
              f"{rec['bound_ms']:.4f} ms")
        if c == 100:
            recs["compress_f64"] = rec
            x1 = x[0].contiguous()
            recs["compress_1d_f64"] = check_compress(x1, perm[:1], c, s, 200,
                                                     20)
        else:  # the [convex_full] shape rides along
            recs["compress_f64"].update(
                {f"full_{k}": rec[k] for k in ("shape", "max_abs_err", "ms",
                                               "plain_ms", "bound_ms",
                                               "kernel_ms", "kernel_ms_by",
                                               "host_ms")})
        del x
    x = torch.randn(N, d_total, generator=g, device=dev)
    x[1] = float("nan")  # the idle row never reaches the output
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    recs["compress_f32"] = check_compress(x, slot, C, S, 5, 2)
    x1 = x[0]
    recs["compress_1d_f32"] = check_compress(x1, slot[:1], C, S, 10, 2)
    del x, x1
    torch.cuda.empty_cache()
    return [recs[k] for k in ("compress_f64", "compress_f32",
                              "compress_1d_f64", "compress_1d_f32")]


def check_convex_card_vs_cpu(prob, cfg, rounds: int = 5) -> None:
    """Gate (a): the first rounds of ``tamuna.run`` on the card against the
    same rounds, same schedule, on the CPU (plain versions): x_bar and h
    within 1e-10 relative."""
    from repro_torch.core import tamuna

    card = tamuna.run(prob, cfg, rounds, record_every=rounds)["state"]
    cpu = tamuna.run(prob.to("cpu"), cfg, rounds,
                     record_every=rounds)["state"]
    errs = [float((a.cpu() - b).abs().max() / b.abs().max())
            for a, b in ((card.x_bar, cpu.x_bar), (card.h, cpu.h))]
    print(f"[convex] first {rounds} rounds ({card.total_local_steps} local "
          f"steps) on the card vs the CPU: relative max err x_bar "
          f"{errs[0]:.3e}, h {errs[1]:.3e} (tolerance 1e-10)")
    if not (max(errs) <= 1e-10
            and card.total_local_steps == cpu.total_local_steps):
        raise AssertionError(f"[convex] card vs CPU: {errs}")


def run_convex_path(tag, prob, c: int, rounds: int):
    """Drive ``tamuna.run`` for ``rounds`` rounds of the paper-scale
    problem at cohort ``c`` (records every 10 rounds, as Fig. 3's) with
    the launch counts set to 0 just before and read just after; gates (b)
    sum_i h_i = 0 to 1e-10 of max|h|, (c) a finite suboptimality that
    ends below where it started and (d) two ``compress_f64`` launches per
    round.  Returns the launch counts and the trace (without its
    state)."""
    from repro_torch.core import tamuna, theory
    from repro_torch.kernels import _build

    cfg = tamuna.TamunaConfig.tuned(prob, c=c)
    print(f"[{tag}] n={prob.n} d={prob.d} c={c} s={cfg.s} p={cfg.p:.6f} "
          f"(1/p = {1 / cfg.p:.3f} local steps per round) gamma="
          f"{cfg.gamma:.6e} eta={cfg.eta:.6f}, {rounds} rounds, float64")
    start = float(prob.suboptimality(torch.zeros_like(prob.x_star)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tr = tamuna.run(prob, cfg, rounds, seed=0, record_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    state = tr["state"]
    shown = set(range(0, len(tr["rounds"]), max(1, len(tr["rounds"]) // 8)))
    for i, r in enumerate(tr["rounds"]):
        if i not in shown | {len(tr["rounds"]) - 1}:
            continue
        print(f"[{tag}] round {r}: local steps {tr['local_steps'][i]} "
              f"suboptimality {tr['suboptimality'][i]:.6e} lyapunov "
              f"{tr['lyapunov'][i]:.6e} at {tr['seconds'][i]:.3f} s")
    steps = state.total_local_steps
    print(f"[{tag}] {rounds} rounds, {steps} local steps in {wall:.3f} s: "
          f"{wall / rounds * 1e3:.4f} ms per round, "
          f"{wall / steps * 1e3:.4f} ms per local step ({len(tr['rounds'])}"
          f" record points included); up_floats {state.up_floats:.0f} "
          f"down_floats {state.down_floats:.0f} per client")
    print(f"[{tag}] launches {({k: v for k, v in launches.items() if v})}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    chi = cfg.eta / cfg.p
    tau = theory.theorem1_rate(cfg.gamma, prob.mu, prob.L, cfg.p, chi,
                               prob.n, cfg.s)
    ly, st = tr["lyapunov"], tr["local_steps"]
    rate = (ly[-1] / ly[0]) ** (1.0 / (st[-1] - st[0]))
    print(f"[{tag}] Theorem 1 tau = {tau:.10f} per local step; measured "
          f"Lyapunov rate {rate:.10f} per local step over steps "
          f"{st[0]}..{st[-1]}")
    ratio = h_sum_ratio(state.h, prob.d)
    print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e} (limit 1e-10); "
          f"suboptimality {start:.6e} at x0 = 0 -> "
          f"{tr['suboptimality'][-1]:.6e}")
    if not ratio <= 1e-10:
        raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: {ratio}")
    sub = tr["suboptimality"]
    if not (np.isfinite(sub).all() and sub[-1] < start and sub[-1] < sub[0]):
        raise AssertionError(f"[{tag}] suboptimality did not fall: {sub}")
    others = {k: v for k, v in launches.items() if k != "compress_f64" and v}
    if launches["compress_f64"] != 2 * rounds or others:
        raise AssertionError(f"[{tag}] want 2 compress_f64 launches per "
                             f"round and nothing else: {launches}")
    del tr["state"], state
    torch.cuda.empty_cache()
    return launches, tr


def same_values(a, b) -> bool:
    """Equal values (a zero's sign aside), NaN where both are NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def run_convex_bench(dev) -> dict:
    """``[convex_bench]``: the reference's convex round-count benches
    (``benchmarks/faults_bench.py`` and the convergence half of
    ``quant_comm_bench.py``) at their full size through
    ``repro_torch.launch.convex_bench`` on the card, every row beside the
    reference's ``BENCH_faults.json`` / ``BENCH_quant_comm.json`` value.
    Gates: the benches' own acceptance (quorum within 2x the fault-free
    rounds at p_fail 0.2, the wait-all control stalls, a bitwise replay,
    the int8 floor within 10x of f32's) and no kernel launch (the plain
    comm step).  Then ``benchmarks/robust_bench.py`` (16 clients, c = s =
    12, a Byzantine quarter) through ``convex_bench.run_robust``, every row
    beside ``BENCH_robust.json``'s, gated on its acceptance but the
    overhead (both robust aggregators within 2x the fault-free rounds, both
    mean controls stall, the replay and the identity bitwise, the int8
    deviation at most 0.25), its drivers launching nothing (only its
    kernel-path timing and identity check launch ``masked_sum``,
    ``robust_sum`` and ``h_update``); prints the robust comm step's cost
    over the mean's at (16, 65536), s = 4, ws and kernel path.  Counts
    that differ from the BENCH files are printed, not gated: the
    trajectories are the reference's to the last f32 bit only where the
    f64 local steps round alike.  Returns the launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.launch import convex_bench

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BENCH_faults.json")) as f:
        ref_f = json.load(f)
    with open(os.path.join(here, "BENCH_quant_comm.json")) as f:
        ref_q = json.load(f)["convergence"]
    with open(os.path.join(here, "BENCH_robust.json")) as f:
        ref_r = json.load(f)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    bench = convex_bench.ConvexBench.for_bench(False, dev)
    t1 = time.perf_counter()
    faults = convex_bench.run_faults(bench)
    t2 = time.perf_counter()
    quant = convex_bench.run_quant(bench)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(_build.launch_counts)
    print(f"[convex_bench] n={bench.n} d={bench.d} c={bench.c} "
          f"s={bench.cfg.s} L={bench.L} float64 on the card: set-up "
          f"{t1 - t0:.3f} s, faults {t2 - t1:.3f} s, quant {t3 - t2:.3f} s")
    differ = []

    def show(tag, got, want, keys):
        same = all(got[k] == want[k] for k in keys)
        if not same:
            differ.append(tag)
        print(f"[convex_bench] {tag}: "
              + ", ".join(f"{k} {got[k]} (BENCH {want[k]})" for k in keys)
              + f"; final {got['final_suboptimality']:.6e} (BENCH "
              f"{want['final_suboptimality']:.6e})"
              + ("" if same else "  <- differs"))

    for got, want in zip(faults["rows"], ref_f["rows"]):
        show(f"faults p_fail={got['p_fail']} {got['policy']}", got, want,
             ("rounds_to_target", "retries", "quorum_miss"))
        print(f"[convex_bench]   x_fingerprint {got['x_fingerprint']} "
              f"(BENCH {want['x_fingerprint']})")
    for k in ("fault_free_rounds", "quorum_ratio_at_p02",
              "wait_all_control_stalls_at_p02", "deterministic_replay_ok"):
        print(f"[convex_bench] {k} {faults[k]} (BENCH {ref_f[k]})")
    for got, want in zip(quant["rows"], ref_q["rows"]):
        show(f"quant {got['kind']}", got, want,
             ("rounds", "rounds_to_target"))
        print(f"[convex_bench]   floor {got['floor']:.6e} (BENCH "
              f"{want['floor']:.6e})")
    print(f"[convex_bench] matched rounds {quant['matched_rounds']} (BENCH "
          f"{ref_q['matched_rounds']}), floor_ratio_int8_vs_f32 "
          f"{quant['floor_ratio_int8_vs_f32']:.4f} (BENCH "
          f"{ref_q['floor_ratio_int8_vs_f32']:.4f}; the wire seeds are "
          f"the port's stream, not the reference's threefry)")
    print(f"[convex_bench] rows that differ from the BENCH files: "
          f"{differ or 'none'}; launches "
          f"{({k: v for k, v in launches.items() if v})}")
    ratio = faults["quorum_ratio_at_p02"]
    if not (ratio is not None and ratio <= 2.0
            and faults["wait_all_control_stalls_at_p02"]
            and faults["deterministic_replay_ok"]
            and quant["floor_ratio_int8_vs_f32"] <= 10.0
            and not any(launches.values())):
        raise AssertionError(f"[convex_bench] acceptance failed: quorum "
                             f"ratio {ratio}, {faults}, {quant}")

    _build.reset_launch_counts()
    t4 = time.perf_counter()
    rob = convex_bench.run_robust(bench)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    rob_launches = {k: v for k, v in _build.launch_counts.items() if v}
    cfg_r = rob["config"]
    print(f"[convex_bench] robust n={cfg_r['n']} d={cfg_r['d']} c="
          f"{cfg_r['c']} s={cfg_r['s']} trim_k={cfg_r['trim_k']} L="
          f"{cfg_r['L']} byzantine {cfg_r['byzantine']} (BENCH "
          f"{ref_r['config']['byzantine']}): {t5 - t4:.3f} s")
    differ = []
    for got, want in zip(rob["rows"], ref_r["rows"]):
        show(f"robust {got['attack']}/{got['agg']}", got, want,
             ("rounds_to_target", "diverged", "guarded_rows",
              "quarantine_windows", "quarantined_byz_only"))
        gf, wf = got["x_fingerprint"], want["x_fingerprint"]
        dev_fp = (None if gf is None or wf is None
                  else max(abs(a - b) for a, b in zip(gf, wf))
                  / max(abs(b) for b in wf))
        print(f"[convex_bench]   x_fingerprint {gf} (BENCH {wf}); max "
              f"difference over the largest entry {dev_fp}")
    for k in ("fault_free_rounds", "ratios", "mean_control_stalls",
              "deterministic_replay_ok", "identity_bitwise_ok",
              "int8_wire_max_dev"):
        print(f"[convex_bench] robust {k} {rob[k]} (BENCH {ref_r[k]})")
    us, kus = rob["comm_step_us"], rob["kernel_comm_step_us"]
    print(f"[convex_bench] robust comm step at (n={cfg_r['n']}, d="
          f"{rob['overhead_shape']['d']}), s={rob['overhead_shape']['s']}, "
          f"us per step: ws mean {us['mean']:.1f}, trimmed "
          f"{us['trimmed']:.1f}, median {us['median']:.1f} (robust over "
          f"mean {rob['robust_overhead_ratio']:.3f}x; at s = c "
          f"{rob['robust_overhead_ratio_s_eq_c']:.3f}x); kernel path mean "
          f"{kus['mean']:.1f}, trimmed {kus['trimmed']:.1f}, median "
          f"{kus['median']:.1f} ({rob['kernel_robust_overhead_ratio']:.3f}"
          f"x); not gated")
    print(f"[convex_bench] robust rows that differ from BENCH_robust.json: "
          f"{differ or 'none'}; launches {rob_launches}")
    if not (convex_bench.robust_accepted(rob)
            and set(rob_launches) <= {"masked_sum", "robust_sum",
                                      "h_update"}):
        raise AssertionError(f"[convex_bench] robust acceptance failed: "
                             f"{rob}, launches {rob_launches}")
    for k, v in rob_launches.items():
        launches[k] += v
    return launches


def run_convex_comm(prob, dev) -> dict:
    """``[convex_comm]``: the plain comm implementations at Fig. 3's paper
    scale (n=1000, d=20958, c=100, s=2, f64 storage): 3 quorum rounds at
    p_fail 0.2, one int8 ``wire_down`` round and one quorum round with the
    median combiner (``robust=("median", 0)``: the ws owner stack of 2, the
    dense sort over 1000 rows, the ``robust_sum`` kernel) of the convex
    bench's driver.  Each comm step's ws output is held against dense on
    the card (equal values, a zero's sign aside), against ws on the CPU on
    the same inputs (bitwise) and against the workspace kernel path
    (``comm_ws.cyclic_comm``) on an f32 copy (within 2**-20 of
    max(1, |value|): the kernels add the owners in row order).  Prints ms
    per comm step of each and the peak memory; returns the launch counts
    of ws and dense (none)."""
    from repro_torch.dist import comm_ws
    from repro_torch.dist.cohort import CohortPlan
    from repro_torch.dist.faults import FaultModel, FaultPlan
    from repro_torch.kernels import _build
    from repro_torch.launch import convex_bench as cb

    c = 100
    bench = cb.ConvexBench(prob, c)
    n, d, s = bench.n, bench.d, bench.cfg.s
    plan = CohortPlan(seed=7, n=n, c=c)
    faults = FaultPlan(seed=3, n=n, model=FaultModel(p_drop=0.2))
    band = comm_ws.cyclic_band([d], c, s, dev)
    x_bar = torch.zeros(d, dtype=torch.float64, device=dev)
    h = torch.zeros(n, d, dtype=torch.float64, device=dev)
    ms = {"ws": [], "dense": [], "kernel": []}
    kernel_launches = {k: 0 for k in _build.launch_counts}
    plain_launches = {k: 0 for k in _build.launch_counts}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed(tag, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        ms[tag].append(start.elapsed_time(end))
        return out

    for g in range(5):
        if g != 3:  # the quorum rounds, the last one with the median
            cohort, arrived, attempt, _ = cb.resolve_round(
                plan, faults, g, c // 2 + 1)
            kw = dict(arrived=torch.from_numpy(arrived).to(dev))
            desc = (f"quorum round {g}: attempt {attempt}, "
                    f"{int(arrived.sum())} of {c} arrived")
            if g == 4:
                kw["robust"] = ("median", 0)
                desc = "median " + desc
            kern_kw = dict(kw)
        else:  # the int8 wire_down round
            cohort = plan.cohort(g)
            attempt = 0
            seed = cb.port_wire_seeds(g + 1)[g]
            kw = dict(wire="int8", wire_seed=seed, wire_down=True)
            kern_kw = dict(wire=comm_ws.wire_plan([d], "int8", c, s, band),
                           wire_seed=seed, wire_down=True)
            desc = "int8 wire_down round"
        perm = cb.round_permutation(g, attempt, c)
        cohort_t = torch.from_numpy(cohort.astype(np.int64)).to(dev)
        slot = bench.slot_of(cohort, perm)
        Xc = bench.local_steps(x_bar, h, cohort_t)
        X = x_bar.expand(n, d).clone()
        X[cohort_t] = Xc
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        ws = timed("ws", lambda: comm_ws.cyclic_comm_leaves(
            X, h, slot, c, s, bench.scale, impl="ws", **kw))
        dense = timed("dense", lambda: comm_ws.cyclic_comm_leaves(
            X, h, slot, c, s, bench.scale, impl="dense", **kw))
        for k, v in _build.launch_counts.items():
            plain_launches[k] += v
        with intra_op_threads(REDUCED_CPU_THREADS):
            cpu = comm_ws.cyclic_comm_leaves(
                X.cpu(), h.cpu(), slot.cpu(), c, s, bench.scale, impl="ws",
                **{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                   for k, v in kw.items()})
        xw, hw = X.float(), h.float()
        _build.reset_launch_counts()
        timed("kernel", lambda: comm_ws.cyclic_comm(
            xw, hw, slot.to(torch.int32), band, c, s, bench.scale,
            **kern_kw))
        torch.cuda.synchronize()
        for k, v in _build.launch_counts.items():
            kernel_launches[k] += v
        errs = {}
        for name, a, b_dense, b_cpu, b_kern in (
                ("x", ws[0], dense[0], cpu[0], xw),
                ("h", ws[1], dense[1], cpu[1], hw)):
            if not same_values(a, b_dense):
                raise AssertionError(f"[convex_comm] {desc}: ws and dense "
                                     f"differ in {name}")
            if not torch.equal(a.cpu().view(torch.int64),
                               b_cpu.view(torch.int64)):
                raise AssertionError(f"[convex_comm] {desc}: ws on the "
                                     f"card and the CPU differ in {name}")
            errs[name] = max_abs_err(a.float(), b_kern)
            tol = 2.0 ** -20 * max(1.0, float(a.abs().max()))
            if not errs[name] <= tol:
                raise AssertionError(f"[convex_comm] {desc}: ws and the "
                                     f"kernel path differ in {name} by "
                                     f"{errs[name]} > {tol}")
        x_bar = bench.server_model(ws[0], cohort)
        h = ws[1]
        print(f"[convex_comm] {desc}: ws vs dense equal, ws card vs CPU "
              f"bitwise, ws vs the kernel path max abs err x "
              f"{errs['x']:.3e} h {errs['h']:.3e}; ms ws "
              f"{ms['ws'][-1]:.3f} dense {ms['dense'][-1]:.3f} kernel "
              f"{ms['kernel'][-1]:.3f}; suboptimality "
              f"{bench.suboptimality(x_bar):.6e}")
        del ws, dense, cpu, xw, hw, X, Xc
    peak = torch.cuda.max_memory_allocated()
    # the first step of each includes its warm-up
    mean = {k: sum(v[1:3]) / 2 for k, v in ms.items()}
    print(f"[convex_comm] n={n} d={d} c={c} s={s} f64 storage: ms per "
          f"comm step (quorum rounds 1-2) ws {mean['ws']:.3f}, dense "
          f"{mean['dense']:.3f}, kernel path (f32 workspace) "
          f"{mean['kernel']:.3f}; int8 wire_down round ws "
          f"{ms['ws'][3]:.3f}, dense {ms['dense'][3]:.3f}, kernel path "
          f"{ms['kernel'][3]:.3f}; median round ws {ms['ws'][4]:.3f}, "
          f"dense {ms['dense'][4]:.3f}, kernel path {ms['kernel'][4]:.3f};"
          f" max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    print(f"[convex_comm] the kernel path's launches "
          f"{({k: v for k, v in kernel_launches.items() if v})}")
    if any(plain_launches.values()):
        raise AssertionError(f"[convex_comm] the plain implementations "
                             f"launched kernels: {plain_launches}")
    if not kernel_launches["robust_sum"]:
        raise AssertionError("[convex_comm] the median round's kernel path "
                             "did not launch robust_sum")
    torch.cuda.empty_cache()
    return plain_launches


def run_reputation(cfg, dev) -> dict:
    """``[reputation]``: the robust round with the anomaly reputation,
    n=5, c=4, s=3, a ``CohortPlan``, one sign-flipping client (f_byz
    0.2), quorum, the trimmed mean k=1 and ``reputation=True``, 4 rounds;
    the launch counts as ``run_path``'s.  Gates: ``run_path``'s, the
    sign-flipped client quarantined once it has arrived unguarded, no
    honest client quarantined.  Prints the windows and ``anomaly_scores``'
    own time at full width (CUDA events).  Returns the launch counts."""
    from repro_torch.dist import cohort, comm_ws, faults, model_api, robust
    from repro_torch.dist import tamuna_dp

    class RecordingReputation(robust.Reputation):
        """The reputation with each update's unguarded arrivals kept."""

        def __init__(self, n):
            super().__init__(n)
            self.arrived = []

        def update(self, anomaly, arrived):
            self.arrived.append(np.asarray(arrived, bool).copy())
            return super().update(anomaly, arrived)

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P,
                                      robust_agg="trimmed", trim_k=1)
    plan = cohort.CohortPlan(0, NF, CF)
    fp = faults.FaultPlan(seed=0, n=NF, adversary="sign_flip", f_byz=0.2)
    rep = RecordingReputation(NF)
    launches = run_path(
        "reputation", cfg, tcfg, NF, dev,
        need=("robust_sum", "h_update_covered", "fused_local_step"),
        check_h_sum=False, rounds_=4, plan=plan, faults=fp,
        policy="quorum", reputation=rep)
    byz = set(np.flatnonzero(fp.byzantine).tolist())
    windows = [(ids.tolist(), a, b) for ids, a, b in plan._quarantine]
    quarantined = {i for ids, _, _ in windows for i in ids}
    seen = {i for arr in rep.arrived for i in np.flatnonzero(arr).tolist()}
    print(f"[reputation] byzantine {sorted(byz)}; arrived unguarded in some "
          f"round: {sorted(seen)}; quarantine windows (clients, first, "
          f"last round) {windows}; strikes {rep.strikes.tolist()}")
    if not (quarantined <= byz and (byz & seen) <= quarantined):
        raise AssertionError(f"[reputation] want every Byzantine client "
                             f"that arrived unguarded quarantined and no "
                             f"honest one: windows {windows}, arrived "
                             f"{sorted(seen)}, byzantine {sorted(byz)}")
    # anomaly_scores' own time on a full-width (NF, d) workspace
    d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(NF, d, generator=g, device=dev)
    mask = np.array([True, True, False, True, True])
    robust.anomaly_scores(x, mask)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    scores = robust.anomaly_scores(x, mask)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    # the rows it reads, once: a bound by bytes
    print(f"[reputation] anomaly_scores on ({NF}, {d}) f32, 4 rows listed: "
          f"{ms:.3f} ms (CUDA events; the rows read once: "
          f"{bound_ms(4 * d * 4):.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s);"
          f" scores {[round(float(v), 6) for v in scores]}")
    del x
    torch.cuda.empty_cache()
    return launches


def run_baselines(prob, tamuna_traces: dict) -> dict:
    """``[baselines]``: paper Fig. 3 at paper scale
    (``benchmarks/paper_fig3.py --paper-scale``) through
    ``repro_torch.launch.paper_bench`` on the card: Scaffold at half the GD
    step with L = 1/p local steps for 2000 rounds and, at full
    participation, Scaffnew for 12,000 iterations, beside TAMUNA's traces
    of ``[convex]`` (10% participation) and ``[convex_full]`` (full), each
    algorithm's TotalCom to 1e-6 of the initial gap at alpha 0 and 0.1.
    Gates: finite suboptimalities that end below where they start; no
    launch (the baselines are plain torch).  Returns the launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.launch import paper_bench

    target = paper_bench.gap_target(prob)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    traces = paper_bench.figure_traces(prob, 8000, seed=0,
                                       tamuna_traces=tamuna_traces)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    print(f"[baselines] Fig. 3 at paper scale (n={prob.n}, d={prob.d}), "
          f"target 1e-6 of the initial gap = {target:.6e}; baselines in "
          f"{wall:.3f} s")
    bad = []
    for regime, by_algo in traces.items():
        for name, tr in by_algo.items():
            sub = tr["suboptimality"]
            t = tr["seconds"][-1]
            print(f"[baselines] {regime} {name}: {tr['rounds'][-1]} rounds "
                  f"in {t:.3f} s ({t / tr['rounds'][-1] * 1e3:.4f} ms per "
                  f"round, records included); suboptimality {sub[0]:.6e} "
                  f"-> {sub[-1]:.6e}; up_floats {tr['up_floats'][-1]:.0f} "
                  f"down_floats {tr['down_floats'][-1]:.0f}")
            if not (np.isfinite(sub).all() and sub[-1] < sub[0]):
                bad.append(f"{regime}/{name}")
    for row in paper_bench.figure_rows("fig3", traces, target):
        print(f"[baselines] {row['regime']} alpha={row['alpha']} "
              f"{row['algo']}: floats to target {row['floats_to_target']}, "
              f"final suboptimality {row['final_subopt']:.6e}")
    print(f"[baselines] launches "
          f"{({k: v for k, v in launches.items() if v})}")
    if bad or any(launches.values()):
        raise AssertionError(f"[baselines] suboptimality not finite and "
                             f"falling in {bad}, or launches {launches}")
    return launches


def h_sum_ratio(h, d: int) -> float:
    """|sum_i h_i| / max|h| over the ``(n, d)`` control variates, in
    column chunks."""
    hsum = max(float(h[:, a:a + (1 << 27)].sum(0).abs().max())
               for a in range(0, d, 1 << 27))
    hmax = float(h.abs().max())
    return hsum / hmax if hmax > 0 else math.inf


def run_family_paths(dev) -> dict:
    """``[train_stablelm]`` and ``[train_prefix]``: the fault-free round
    of ``[train]`` (3 rounds, seq 128, 2 sequences per client, max_L 4) on
    stablelm-3b (q/k/v biases, untied head) cut to
    TRAIN_STABLELM_LAYERS layers at N clients, and on internvl2-26b (its
    256 prefix embeddings before the 128 text tokens, untied head) cut to
    TRAIN_PREFIX's layer at its 3 clients: a row of 1,566,590,976 f32, so
    every kernel's row offsets pass 2^31.  Gated as ``[train]``."""
    from repro_torch.configs import registry
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    out = {}
    tp = TRAIN_PREFIX
    for tag, arch, layers, n, c, s in (
            ("train_stablelm", "stablelm-3b", TRAIN_STABLELM_LAYERS, N, C, S),
            ("train_prefix", "internvl2-26b", tp["layers"], tp["n"], tp["c"],
             tp["s"])):
        full = registry.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
        print(f"[{tag}] {cfg.name} at published widths (d_model "
              f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads, head_dim "
              f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, q/k/v "
              f"biases {cfg.qkv_bias}, tied head {cfg.tie_embeddings}, prefix "
              f"{cfg.prefix_len}); depth cut {full.n_layers} -> {layers}; "
              f"d_total {d} f32 per client row, x and h {2 * n * d * 4} B")
        tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P)
        out[tag] = run_path(tag, cfg, tcfg, n, dev,
                            need=("masked_sum", "h_update",
                                  "fused_local_step"),
                            check_h_sum=True)
    return out


def zamba2_diagnostic(tag, cfg, n, seq, dev) -> None:
    """What keeps ``[train_zamba2]`` at ``seq`` tokens and a small gamma,
    printed and not gated: the loss of the initial parameters at 128
    tokens, and at ``seq`` tokens before and after one plain SGD step of
    GAMMA on that loss (one client's batch)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import model_api

    params = model_api.init(cfg, seed=0, device=dev)
    losses = []
    for t in (128, seq):
        batch = SyntheticTokenPipeline(
            DataConfig(seq_len=t, per_client_batch=2, vocab=512, seed=0,
                       n_clients=n), cfg, dev).sample_batch([0])
        tok, lab = batch["tokens"][0], batch["labels"][0]
        leaves = [v.requires_grad_(True) for v in params.values()]
        loss, _ = model_api.loss(params, cfg, tokens=tok, labels=lab)
        losses.append(float(loss))
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            v.sub_(GAMMA * g)
        del grads
        losses.append(float(model_api.loss(params, cfg, tokens=tok,
                                           labels=lab)[0]))
    print(f"[{tag}] initial parameters: loss at 128 tokens "
          f"{losses[0]!r}, at {seq} tokens {losses[1]!r}; after one SGD "
          f"step of gamma {GAMMA} at {seq} tokens {losses[2]!r} (not "
          f"gated; the reference's scan factorization overflows f32 where "
          f"a chunk's decay passes e^-88)")
    del params, leaves, loss
    torch.cuda.empty_cache()


def run_new_family_paths(dev) -> dict:
    """``[train_moe]``, ``[train_qwen3]``, ``[train_rwkv]`` and
    ``[train_zamba2]``: ``[train]``'s fault-free round (3 rounds, 2
    sequences per client, max_L 4) on TRAIN_FAMILIES' configs at published
    widths cut in depth, gated as ``[train]``.  The MoE paths take the
    dense dispatch (b t top_k > num_experts).  zamba2 trains on
    TRAIN_SEQ's 32 tokens at TRAIN_GAMMA's step, after
    ``zamba2_diagnostic`` (ROADMAP C)."""
    from repro_torch.configs import registry
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    out = {}
    for tag, arch, layers, n, c, s in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        full = registry.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
        seq = TRAIN_SEQ.get(arch, 128)
        print(f"[{tag}] {cfg.name} at published widths ({cfg.family}: "
              f"d_model {cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, experts "
              f"{cfg.num_experts} top-{cfg.top_k} moe_d_ff {cfg.moe_d_ff} "
              f"shared_d_ff {cfg.shared_d_ff} renormalize {cfg.renormalize}, "
              f"d_state {cfg.d_state}, shared_attn_every "
              f"{cfg.shared_attn_every}); depth cut {full.n_layers} -> "
              f"{layers}; seq {seq}; d_total {d} f32 per client row "
              f"({d * 4} B), x and h {2 * n * d * 4} B")
        gamma = TRAIN_GAMMA.get(arch, GAMMA)
        if seq != 128 or gamma != GAMMA:
            zamba2_diagnostic(tag, cfg, n, seq, dev)
        tcfg = tamuna_dp.DistTamunaConfig(gamma=gamma, c=c, s=s, p=P)
        print(f"[{tag}] gamma {gamma}")
        out[tag] = run_path(tag, cfg, tcfg, n, dev,
                            need=("masked_sum", "h_update",
                                  "fused_local_step"),
                            check_h_sum=True, seq_len=seq)
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    return out


class lost_owner:
    """Inside the block, the comm step's h update drops the first owner
    row's update (a lost owner): a planted fault for the sum_i h_i = 0
    gate to catch."""

    def __enter__(self):
        from repro_torch.kernels import uplink

        self.h_update = h_update = uplink.h_update

        def dropped(x, h, x_bar, slot, band, m, *args, **kw):
            slot = slot.clone()
            slot[int(((slot >= 0) & (slot < m)).nonzero()[0])] = -1
            h_update(x, h, x_bar, slot, band, m, *args, **kw)

        uplink.h_update = dropped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import uplink

        uplink.h_update = self.h_update


def profile_member_step(tag, cfg, dev, reps: int = 3) -> None:
    """One client's local-step gradient (``model_api.loss`` forward and
    backward on one batch of ``[train]``'s shape, frames included) run
    ``reps`` times under ``torch.profiler`` after one warm-up: wall time
    per step, the device's busy time per step and the kernels that take
    most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import model_api

    params = model_api.init(cfg, seed=0, device=dev)
    leaves = [v.requires_grad_(True) for v in params.values()]
    batch = {k: v[0] for k, v in SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=1), cfg, dev).sample_batch([0]).items()}

    def step():
        loss, _ = model_api.loss(params, cfg, **batch)
        return torch.autograd.grad(loss, leaves)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / reps / 1e3
    launches = sum(e.count for e in rows) // reps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[{tag}] profiled member step (one client's loss and gradients, "
          f"{reps} times): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.1%}) in {launches} kernel "
          f"launches; top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / reps / 1e3:.3f}"
                      f" ms x{e.count // reps}" for e in top))
    del params, leaves, batch
    torch.cuda.empty_cache()


def planted_lost_owner(tag, state, cfg, tcfg, n, done, dev, *, seq_len,
                       batch) -> None:
    """The control of the sum_i h_i = 0 gate on the f32 rounding bound: a
    further round of ``state`` (after ``done`` rounds, one local step of
    ``seq_len`` tokens, ``batch`` sequences per client) with a lost owner
    planted (``lost_owner``) must read over 1000 times the bound
    ``tamuna_dp.h_sum_rounding`` derives."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, tamuna_dp

    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=seq_len, per_client_batch=batch, vocab=512,
                   seed=1, n_clients=n), cfg, dev)
    with lost_owner():
        state, _ = rounds.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=1,
            rng=np.random.default_rng(1),
            generator=torch.Generator().manual_seed(2), max_L=1)
    share, ulps, leaf = tamuna_dp.h_sum_rounding(state, tcfg, n, done + 1)
    d = state.spec.d_total
    print(f"[{tag}] a lost owner planted in round {done + 1}: "
          f"{share:.4g} of the bound, {ulps:.4g} ulps of max|x| ({leaf}), "
          f"|sum_i h_i| / max|h| = {h_sum_ratio(state.h, d):.3e}")
    if not share > 1000:
        raise AssertionError(f"[{tag}] the gate missed a lost owner: "
                             f"{share} of the bound")


def run_whisper_path(dev) -> dict:
    """``[train_whisper]``: ``[train]``'s fault-free round (3 rounds, seq
    128, 2 sequences per client, max_L 4) on whisper-tiny at published
    widths and full depth, its batches carrying 1,500 frames per
    sequence, over a federated population: TRAIN_WHISPER's n = 128
    clients, c = 16, s = 2; then one member step profiled
    (``profile_member_step``).  Gated as ``[train]`` but for sum_i h_i = 0,
    which is gated on its f32 rounding: every leaf's |sum_i h_i| within
    H_SUM_HEADROOM times the bound ``tamuna_dp.h_sum_rounding`` derives
    (``R scale s (s - 1) / 2`` ulps of the leaf's max|x| plus ``2 R s`` of
    its max|h|).  The headroom is for what the bound reads from the final
    state only: a max|x| that changed binade, or a max|h| that shrank,
    during the rounds.  Then a fourth round with a lost owner planted
    (``lost_owner``) must read over 1000 times the bound.  The LM paths'
    ``|sum_i h_i| / max|h| <= 1e-4`` is printed, not gated: whisper-tiny's
    max|h| is ~1e-2 against its layernorm scales' max|x| = 1, and the
    rounding bound alone is ~1.6e-4 of it there (PERF.md, ROADMAP C)."""
    from repro_torch.configs import whisper_tiny
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    t0 = time.perf_counter()
    cfg, tw = whisper_tiny.CONFIG, TRAIN_WHISPER
    specs = model_api.param_specs(cfg)
    d = comm_ws.workspace_spec(specs).d_total
    print(f"[train_whisper] {cfg.name} at published widths and full depth "
          f"({cfg.family}: d_model {cfg.d_model}, {cfg.n_encoder_layers} "
          f"encoder + {cfg.n_layers} decoder layers, {cfg.n_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_frames} frames); {len(specs)} leaves, d_total {d} f32 "
          f"per client row ({d * 4} B), x and h {2 * tw['n'] * d * 4} B")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=tw["c"], s=tw["s"],
                                      p=P)
    out, state, rows = run_path(
        "train_whisper", cfg, tcfg, tw["n"], dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=False, keep=True)
    share, ulps, leaf = tamuna_dp.h_sum_rounding(state, tcfg, tw["n"],
                                                 len(rows))
    print(f"[train_whisper] worst leaf's |sum_i h_i| against its f32 "
          f"rounding bound after {len(rows)} rounds: {share:.4f} of it, "
          f"{ulps:.4f} ulps of its max|x| ({leaf}); gate "
          f"{H_SUM_HEADROOM} of it")
    if not share <= H_SUM_HEADROOM:
        raise AssertionError(f"[train_whisper] sum_i h_i = 0 beyond f32 "
                             f"rounding: {share} of the bound on {leaf}")
    planted_lost_owner("train_whisper", state, cfg, tcfg, tw["n"],
                       len(rows), dev, seq_len=128, batch=2)
    del state, rows
    torch.cuda.empty_cache()
    profile_member_step("train_whisper", cfg, dev)
    print(f"[train_whisper] phase {time.perf_counter() - t0:.1f} s")
    return out


def compare_on_card(ws: torch.Tensor, host: torch.Tensor,
                    chunk: int = 1 << 26):
    """``(max |ws - host| over the top of |host|, bitwise equal?)`` for an
    ``(n, d)`` workspace on the card against a host copy, a column chunk
    at a time."""
    err, top, same = 0.0, 0.0, True
    for a in range(0, ws.shape[1], chunk):
        g = ws[:, a:a + chunk]
        w = host[:, a:a + chunk].to(ws.device)
        err = max(err, float((g - w).abs().max()))
        top = max(top, float(w.abs().max()))
        same = same and torch.equal(g.view(torch.int32), w.view(torch.int32))
        del w
    return err / top if top else err, same


def time_adamw_step(cfg, dev, reps: int = 5) -> None:
    """AdamW's update of one client row at full width (``adamw_leaf`` over
    every leaf, as the local step runs it) beside one client's forward and
    backward on a batch of 2 x 128 tokens, CUDA events, means over ``reps``
    calls after a warm-up.  The update's bound: it must read x, the
    gradient and both moments and write x and the moments, 28 B per
    coordinate."""
    from repro_torch.dist import comm_ws, model_api, tamuna_dp
    from repro_torch.optim import optimizers

    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    d = spec.d_total
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(d, generator=gen, device=dev).mul_(0.01)
    grad = torch.randn(d, generator=gen, device=dev).mul_(0.01)
    mu, nu = torch.zeros(d, device=dev), torch.zeros(d, device=dev)
    views = [comm_ws.leaf_views(t, spec) for t in (x, grad, mu, nu)]
    mu_hat, nu_hat = optimizers.adamw_bias_scales(1, tamuna_dp.ADAM_B1,
                                                  tamuna_dp.ADAM_B2)

    def adam():
        for k in spec.names:
            optimizers.adamw_leaf(
                *(v[k] for v in views), lr=GAMMA, b1=tamuna_dp.ADAM_B1,
                b2=tamuna_dp.ADAM_B2, eps=tamuna_dp.ADAM_EPS,
                weight_decay=0.0, mu_hat=mu_hat, nu_hat=nu_hat)

    adam_ms = cuda_ms(adam, reps)
    params = {k: v.detach().requires_grad_(True) for k, v in views[0].items()}
    toks = torch.randint(0, 512, (2, 129), generator=gen, device=dev)

    def fwd_bwd():
        loss, _ = model_api.loss(params, cfg, tokens=toks[:, :-1],
                                 labels=toks[:, 1:])
        torch.autograd.grad(loss, list(params.values()))

    fb_ms = cuda_ms(fwd_bwd, reps)
    bound = 28.0 * d / HBM_BYTES_PER_S * 1e3
    print(f"[train_adamw] AdamW update of one client row (d_total {d}, "
          f"{len(spec.names)} leaves in chunks of {optimizers.CHUNK}): "
          f"{adam_ms:.3f} ms, bound {bound:.3f} ms ({bound / adam_ms:.1%} of "
          f"it); one client's forward and backward (2 x 128 tokens) "
          f"{fb_ms:.3f} ms; AdamW over it {adam_ms / fb_ms:.3f}x")
    del x, grad, mu, nu, views, params
    torch.cuda.empty_cache()


def run_train_options(cfg, dev) -> dict:
    """The round's options at gemma2-2b's published widths (2 layers),
    n=4, c=3, s=2, 3 rounds each, launch counts set to 0 per path:
    ``[train_adamw]`` (``local_opt="adamw"``, ``microbatches=2``: launches
    the UpCom and h_update, never ``fused_local_step``; then AdamW's own
    time, ``time_adamw_step``), ``[train_blocked]``
    (``uplink="block_rs"`` on the kernel path, then one comm step each of
    ``comm_impl`` ``"ws"`` and ``"dense"`` from the trained state, held
    against the kernel path's comm step from the same state, which a host
    copy restores between impls), ``[train_all_rows]`` (``elastic=False``:
    every row trains and downloads; ``fused_local_step`` launches ``n L
    leaves`` per round)."""
    from repro_torch.dist import tamuna_dp

    out = {}
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P,
                                      local_opt="adamw", microbatches=2)
    out["train_adamw"] = run_path(
        "train_adamw", cfg, tcfg, N, dev, need=("masked_sum", "h_update"),
        check_h_sum=True, forbid=("fused_local_step",))
    time_adamw_step(cfg, dev)

    tcfg_b = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P,
                                        uplink="block_rs")
    launches, state, _ = run_path(
        "train_blocked", cfg, tcfg_b, N, dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=True, keep=True)
    out["train_blocked"] = launches
    cohort, off, down = [0, 2, 3], 2, torch.tensor([True, True, False, True])
    t0 = time.perf_counter()
    x0, h0 = state.x.cpu(), state.h.cpu()
    t_copy = time.perf_counter() - t0
    kernel = None
    for impl in ("pallas", "ws", "dense"):
        if impl != "pallas":
            state.x.copy_(x0)
            state.h.copy_(h0)
        comm = tamuna_dp.make_comm_step(cfg, tcfg_b, N, device=dev,
                                        impl=impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        comm(state, cohort, down=down, off=off)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        if impl == "pallas":
            kernel = (state.x.cpu(), state.h.cpu())
            print(f"[train_blocked] comm step (cohort {cohort}, off {off}) "
                  f"from the trained state: kernel path {ms:.3f} ms, peak "
                  f"{peak:.2f} GiB; host copies of x and h {t_copy:.1f} s")
            continue
        (ex, bx), (eh, bh) = (compare_on_card(state.x, kernel[0]),
                              compare_on_card(state.h, kernel[1]))
        print(f"[train_blocked] comm_impl={impl}: {ms:.3f} ms, peak "
              f"{peak:.2f} GiB; against the kernel path x {ex:.3e} h "
              f"{eh:.3e} of their largest values (tolerance 2**-20), "
              f"bitwise x {bx} h {bh} (s = 2 adds each coordinate's two "
              f"owners, so the order of adds does not enter)")
        if not (ex <= 2.0 ** -20 and eh <= 2.0 ** -20):
            raise AssertionError(f"[train_blocked] {impl} vs the kernel "
                                 f"path: x {ex} h {eh}")
    del state, x0, h0, kernel
    torch.cuda.empty_cache()

    tcfg_a = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    launches, state, rows = run_path(
        "train_all_rows", cfg, tcfg_a, N, dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=True, keep=True, elastic=False)
    leaves = len(state.spec.names)
    want = sum(N * r["L"] * leaves for r in rows)
    synced = all(torch.equal(state.x[i], state.x[0]) for i in range(1, N))
    print(f"[train_all_rows] fused_local_step launches "
          f"{launches['fused_local_step']} (n L leaves summed over the "
          f"rounds: {want}); every row holds x_bar after the last DownCom: "
          f"{synced}")
    if launches["fused_local_step"] != want or not synced:
        raise AssertionError("[train_all_rows] launches or DownCom")
    out["train_all_rows"] = launches
    del state
    torch.cuda.empty_cache()
    return out


def run_checkpoint(dev, root: str) -> dict:
    """``[checkpoint]``: the reduced gemma2-2b with AdamW (n=4, c=3, s=2,
    microbatches=2) on the card, 4 rounds against 2 rounds, ``save_state``,
    ``restore_state`` into a fresh state and 2 more rounds (the host
    streams carried across), bitwise; prints the save and restore times.
    Writes under ``root`` and removes it."""
    import shutil

    from repro_torch import checkpoint
    from repro_torch.configs import gemma2_2b
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, tamuna_dp
    from repro_torch.kernels import _build

    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P,
                                      local_opt="adamw", microbatches=2)

    def pipe():
        return SyntheticTokenPipeline(
            DataConfig(seq_len=64, per_client_batch=2, vocab=512, seed=0,
                       n_clients=N), cfg, dev)

    def run(state, p, rng, gen, k):
        return rounds.run_rounds(state, cfg=cfg, tcfg=tcfg, pipe=p,
                                 rounds=k, rng=rng, generator=gen,
                                 max_L=4)[0]

    _build.reset_launch_counts()
    whole = run(tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev),
                pipe(), np.random.default_rng(0),
                torch.Generator().manual_seed(1), 4)
    p, rng, gen = pipe(), np.random.default_rng(0), \
        torch.Generator().manual_seed(1)
    part = run(tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev), p,
               rng, gen, 2)
    path = os.path.join(root, "step_2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_state(path, part, part.round)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    fresh = tamuna_dp.init_state(cfg, tcfg, N, seed=3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_state(path, fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    resumed = run(fresh, p, rng, gen, 2)
    launches = dict(_build.launch_counts)
    same = all(torch.equal(a, b) for a, b in (
        (resumed.x, whole.x), (resumed.h, whole.h),
        (resumed.opt.mu, whole.opt.mu), (resumed.opt.nu, whole.opt.nu)))
    same = same and all(getattr(resumed, k) == getattr(whole, k) for k in (
        "round", "up_floats", "down_floats", "up_bytes", "down_bytes")) \
        and resumed.opt.count == whole.opt.count
    shutil.rmtree(root, ignore_errors=True)
    print(f"[checkpoint] {cfg.name} AdamW (n={N} c={C} s={S} microbatches="
          f"2): 4 rounds against 2 + save_state + restore_state + 2 on the "
          f"card: bitwise {same} (count {resumed.opt.count}); save "
          f"{t_save:.3f} s and restore {t_restore:.3f} s of {nbytes} B "
          f"(x, h, mu, nu of {N} rows and the scalars)")
    if not same:
        raise AssertionError("[checkpoint] the resumed run differs")
    return launches


def row_digests(ws: torch.Tensor, chunk: int = 1 << 25,
                zero_sign: bool = False) -> np.ndarray:
    """``(n, 2)`` int64 digest of each row's bits: two sums, wrapping mod
    2**64, of the row's int32 bit patterns times fixed random odd int64
    weights.  Wrapping addition does not depend on the order of the adds,
    so equal rows give equal digests on any run; two rows that differ in
    any bit give equal digests with probability about 2**-128.  With
    ``zero_sign`` -0 digests as +0 (bitwise up to the sign of zero)."""
    n, d = ws.shape
    g = torch.Generator(device=ws.device).manual_seed(2024)
    w = torch.randint(-(1 << 62), 1 << 62, (2, chunk), generator=g,
                      dtype=torch.int64, device=ws.device) | 1
    out = torch.zeros(n, 2, dtype=torch.int64, device=ws.device)
    for a in range(0, d, chunk):
        b = min(a + chunk, d)
        v = ws[:, a:b]
        if zero_sign:
            v = v + 0.0  # -0 + 0 = +0; every other value unchanged
        v = v.view(torch.int32).to(torch.int64)
        out[:, 0] += (v * w[0, :b - a]).sum(1)
        out[:, 1] += (v * w[1, :b - a]).sum(1)
        del v
    return out.cpu().numpy()


class ScriptedPipe:
    """Batches in call order from fixed tokens, moved to ``dev`` (the same
    batches on the card and on the CPU), with the generator a pipe
    checkpoint saves."""

    def __init__(self, toks: np.ndarray, dev):
        self.toks, self.dev, self.used = toks, dev, 0
        self.generator = torch.Generator()

    def sample_batch(self, clients):
        tk = torch.from_numpy(self.toks[self.used]).to(self.dev)
        self.used += 1
        return {"tokens": tk[..., :-1], "labels": tk[..., 1:]}


def run_pipeline(cfg, dev, here: str) -> dict:
    """``[pipeline]``: the pipelined rounds (``run_rounds_pipelined``) of
    2-layer full-width gemma2-2b at n=6, c=3, s=2 (seq 128, 2 sequences
    per client, max_L 4, PIPE_ROUNDS rounds, the clock priced by
    ``benchmarks/artifacts/latency_dist.json``): tau = 0 ``wait_all``
    against ``run_rounds`` on the same seeds (x and h bitwise by
    ``row_digests``, every row's counters equal), tau = 1 ``wait_all``
    and tau = 1 ``quorum`` at q=1 (the survivor UpCom; uncovered > 0 in
    some round) and q=2 (two owners arrive on a third of the
    coordinates, so the survivor h update moves h).  Each run's launch
    counts are set to 0 before it and read after; gated on finite losses,
    every kernel of its path and ``|sum_i h_i| / max|h|``, except the q=1
    run whose every round admits one member: one owner's rebuild is its
    own x, so its h must stay bitwise its initial zeros; prints the clock,
    seconds per round and peak memory."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import comm_ws, faults, model_api, rounds, tamuna_dp
    from repro_torch.kernels import _build

    n, c, s = PIPE["n"], PIPE["c"], PIPE["s"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P)
    d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    lat = faults.EmpiricalDelays.from_json(
        os.path.join(here, PIPE_LATENCY), n=n, seed=0)
    print(f"[pipeline] {cfg.name} 2 layers, n={n} c={c} s={s}, "
          f"{PIPE_ROUNDS} rounds per run, max_L 4, latency "
          f"{PIPE_LATENCY} (p50 {lat.quantile(0.5):.3f} s, p90 "
          f"{lat.quantile(0.9):.3f} s per step)")
    out, digests = {}, {}
    runs = [("pipeline_sync", None, "wait_all", None),
            ("pipeline_tau0", 0, "wait_all", None),
            ("pipeline_wait_all", 1, "wait_all", None),
            ("pipeline_quorum", 1, "quorum", 1),
            ("pipeline_quorum2", 1, "quorum", 2)]
    need = {"wait_all": ("masked_sum", "h_update", "fused_local_step"),
            "quorum": ("masked_sum_counts", "h_update_covered",
                       "fused_local_step")}
    rows_by = {}
    for tag, tau, policy, q in runs:
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev)
        pipe = SyntheticTokenPipeline(
            DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                       n_clients=n), cfg, dev)
        kw = dict(rng=np.random.default_rng(0),
                  generator=torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if tau is None:
            state, rows = rounds.run_rounds(
                state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=PIPE_ROUNDS,
                max_L=4, **kw)
        else:
            engine = rounds.make_pipelined_round_fn(
                cfg, tcfg, n, pipe=pipe, max_L=4, device=dev)
            state, rows = rounds.run_rounds_pipelined(
                state, round_fn=engine, rounds=PIPE_ROUNDS, p=P,
                staleness=tau, latency=lat, policy=policy, quorum=q, **kw)
            del engine
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        for r in rows:
            extra = " ".join(f"{k} {r[k]:.6g}" for k in (
                "dispatch_s", "commit_s", "admitted", "late_dropped",
                "uncovered") if k in r)
            print(f"[{tag}] round {r['round']}: L={r['L']} loss "
                  f"{r['loss']:.6f} wall {r['seconds']:.3f} s"
                  + (f" {extra}" if extra else ""))
        clock = rows[-1].get("commit_s")
        print(f"[{tag}] tau={tau} {policy} q={q}: "
              f"{'' if clock is None else f'simulated clock {clock:.3f} s, '}"
              f"real {secs:.3f} s = {secs / len(rows):.3f} s per round, "
              f"{rows[-1]['local_steps']} local steps; peak "
              f"{peak / 2**30:.2f} GiB; launches {launches}")
        if not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"[{tag}] non-finite loss: {rows}")
        if not all(launches[k] > 0 for k in need[policy]):
            raise AssertionError(f"[{tag}] a kernel of {need[policy]} was "
                                 f"not launched: {launches}")
        if q == 1 and all(r["admitted"] == 1 for r in rows):
            moved = bool(state.h.any())
            print(f"[{tag}] one member admitted per round: h left at its "
                  f"initial zeros {not moved}")
            if moved:
                raise AssertionError(f"[{tag}] h moved with one owner "
                                     "admitted per round")
        else:
            ratio = h_sum_ratio(state.h, d)
            print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e} "
                  "(limit 1e-4)")
            if not ratio <= 1e-4:
                raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: "
                                     f"{ratio}")
        if tau in (None, 0):
            digests[tag] = (row_digests(state.x), row_digests(state.h))
        rows_by[tag] = rows
        out[tag] = launches
        del state, pipe
        torch.cuda.empty_cache()
    keys = ("round", "L", "loss", "local_steps", "up_floats", "down_floats",
            "up_bytes", "down_bytes")
    same_rows = ([[r[k] for k in keys] for r in rows_by["pipeline_sync"]]
                 == [[r[k] for k in keys] for r in rows_by["pipeline_tau0"]])
    same_state = all(np.array_equal(a, b) for a, b in zip(
        digests["pipeline_sync"], digests["pipeline_tau0"]))
    print(f"[pipeline] tau=0 against run_rounds: x and h bitwise "
          f"{same_state} (row digests), every row's counters equal "
          f"{same_rows}")
    if not (same_rows and same_state):
        raise AssertionError("[pipeline] tau=0 differs from run_rounds")
    unc = [r["uncovered"] for r in rows_by["pipeline_quorum"]]
    print(f"[pipeline_quorum] uncovered per round {unc}")
    if not any(u > 0 for u in unc):
        raise AssertionError("[pipeline_quorum] no round left a "
                             "coordinate uncovered")
    return out


def check_reduced_pipelined(dev) -> None:
    """Three staleness-1 rounds of the reduced gemma2-2b under ``quorum``
    q=2 (so the survivor h update moves h) with the latency model (n=6, c=3, s=2, max_L 2) on the card
    against the CPU (one intra-op thread), from the same state, batches,
    cohorts and permutations: the same schedule, and x and h within 1e-5
    (C3's gate)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import faults, rounds, tamuna_dp

    cfg = gemma2_2b.REDUCED
    n, c, s = PIPE["n"], PIPE["c"], PIPE["s"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=0.5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, size=(6, c, 2, 65))
    lat = faults.EmpiricalDelays([0.05, 0.1, 3.0], n=n, seed=5)
    out = {}
    for device in ("cpu", dev):
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
        state.x[1:] += torch.from_numpy(0.01 * np.random.default_rng(
            5).normal(size=(n - 1, state.x.shape[1])).astype(np.float32))
        state.x, state.h = state.x.to(device), state.h.to(device)
        engine = rounds.make_pipelined_round_fn(
            cfg, tcfg, n, pipe=ScriptedPipe(toks, device), max_L=2,
            device=device)
        state, rows = rounds.run_rounds_pipelined(
            state, round_fn=engine, rounds=3, rng=np.random.default_rng(3),
            generator=torch.Generator().manual_seed(1), p=0.5, staleness=1,
            latency=lat, policy="quorum", quorum=2)
        out[str(device)] = (state.x.cpu(), state.h.cpu(), rows)
    (xc, hc, rc), (xg, hg, rg) = out["cpu"], out[str(dev)]
    keys = ("L", "admitted", "late_dropped", "uncovered", "commit_s")
    same = ([[r[k] for k in keys] for r in rc]
            == [[r[k] for k in keys] for r in rg])
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    hmax = float(hc.abs().max())
    print(f"[reduced] 3 pipelined rounds of gemma2-2b-reduced (tau=1, "
          f"quorum 2, n={n} c={c} s={s}) on the card vs the CPU: schedule "
          f"equal {same}, max abs err {err:.3e} (tolerance 1e-5), max|h| "
          f"{hmax:.3e}")
    if not (same and err <= 1e-5 and hmax > 0):
        raise AssertionError(f"reduced pipelined rounds: schedule {same}, "
                             f"err {err}, max|h| {hmax}")


def run_pipeline_ckpt(dev, root: str) -> dict:
    """``[pipeline_ckpt]``: the reduced gemma2-2b with AdamW (n=6, c=3,
    s=2, tau=1, quorum 2 under the latency model) on the card: 6 rounds
    against the same run resumed from its ``pipe_step_3`` (saved with
    round 3 in flight) for its last 3, bitwise in x, h, the moments, the
    count, the counters and every row (clock and local steps included).
    Writes under ``root`` and removes it."""
    import shutil

    from repro_torch.configs import gemma2_2b
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import faults, rounds, tamuna_dp
    from repro_torch.kernels import _build

    cfg = gemma2_2b.REDUCED
    n, c, s = PIPE["n"], PIPE["c"], PIPE["s"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P,
                                      local_opt="adamw")
    lat = faults.EmpiricalDelays([0.05, 0.1, 3.0], n=n, seed=5)

    def run(ck, resume):
        pipe = SyntheticTokenPipeline(
            DataConfig(seq_len=64, per_client_batch=2, vocab=512, seed=0,
                       n_clients=n), cfg, dev)
        engine = rounds.make_pipelined_round_fn(cfg, tcfg, n, pipe=pipe,
                                                max_L=3, device=dev)
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev)
        return rounds.run_rounds_pipelined(
            state, round_fn=engine, rounds=6, rng=np.random.default_rng(0),
            generator=torch.Generator().manual_seed(1), p=P, staleness=1,
            flush_every=3, checkpoint_dir=ck, checkpoint_every=3,
            latency=lat, policy="quorum", quorum=2, resume=resume)

    whole_dir = os.path.join(root, "pipe_whole")
    part_dir = os.path.join(root, "pipe_part")
    shutil.rmtree(root, ignore_errors=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    whole, rows = run(whole_dir, False)
    os.makedirs(part_dir)
    os.rename(os.path.join(whole_dir, "pipe_step_3"),
              os.path.join(part_dir, "pipe_step_3"))
    nbytes = sum(os.path.getsize(os.path.join(part_dir, "pipe_step_3", f))
                 for f in os.listdir(os.path.join(part_dir, "pipe_step_3")))
    resumed, tail = run(part_dir, True)
    launches = dict(_build.launch_counts)
    secs = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in (
        (whole.x, resumed.x), (whole.h, resumed.h),
        (whole.opt.mu, resumed.opt.mu), (whole.opt.nu, resumed.opt.nu)))
    same = same and all(getattr(whole, k) == getattr(resumed, k) for k in (
        "round", "up_floats", "down_floats", "up_bytes", "down_bytes")) \
        and whole.opt.count == resumed.opt.count
    strip = lambda rs: [{k: v for k, v in r.items() if k != "seconds"}
                        for r in rs]
    same_rows = strip(rows[3:]) == strip(tail)
    shutil.rmtree(root, ignore_errors=True)
    print(f"[pipeline_ckpt] {cfg.name} AdamW tau=1 quorum 2 (n={n} c={c} "
          f"s={s}): 6 rounds against 3 + pipe_step_3 ({nbytes} B, round 3 "
          f"in flight) + resume + 3 on the card: state bitwise {same}, "
          f"rows (clock {tail[-1]['commit_s']:.6f} s, local_steps "
          f"{tail[-1]['local_steps']}, count {resumed.opt.count}) equal "
          f"{same_rows}; {secs:.3f} s")
    if not (same and same_rows):
        raise AssertionError("[pipeline_ckpt] the resumed run differs")
    return launches


def run_pipeline_bench(dev, here: str) -> dict:
    """``[pipeline_bench]``: ``launch/pipeline_bench.py``'s sweep on the
    card (the port's own cohorts), each run beside BENCH_pipeline.json's;
    gated on finite losses, ``admitted + late_dropped = c x rounds`` and
    the local steps of each seed (the round lengths are the same numpy
    draws as the reference's)."""
    from repro_torch.dist import faults
    from repro_torch.kernels import _build
    from repro_torch.launch import pipeline_bench

    with open(os.path.join(here, "BENCH_pipeline.json")) as f:
        bench = json.load(f)
    lat = faults.EmpiricalDelays.from_json(
        os.path.join(here, PIPE_LATENCY), n=pipeline_bench.N, seed=0)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipeline_bench.sweep(False, dev, lat)
    secs = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    key = lambda r: (r["tau"], r["policy"], r["seed"])
    want = {key(r): r for r in bench["rows"] + bench["sync_seeds"]}
    ok = True
    for r in out["rows"] + out["sync_seeds"][1:]:
        w = want[key(r)]
        print(f"[pipeline_bench] tau={r['tau']} {r['policy']} q="
              f"{r['quorum']} seed {r['seed']}: clock {r['clock_s']:.3f} s "
              f"(BENCH {w['clock_s']:.3f}), loss {r['loss']:.6f} "
              f"({w['loss']:.6f}), admitted {r['admitted_total']} "
              f"({w['admitted_total']}), late_dropped "
              f"{r['late_dropped_total']} ({w['late_dropped_total']}), "
              f"uncovered {r['uncovered_total']} ({w['uncovered_total']}), "
              f"local_steps {r['local_steps']} ({w['local_steps']}); real "
              f"{r['seconds_per_round']:.4f} s per round")
        rounds_ = out["config"]["rounds"]
        ok &= (r["finite"] and r["local_steps"] == w["local_steps"]
               and r["admitted_total"] + r["late_dropped_total"]
               == pipeline_bench.C * rounds_)
    print(f"[pipeline_bench] speedup_at_tail {out['speedup_at_tail']:.6f} at "
          f"tau {out['speedup_tau']} (BENCH {bench['speedup_at_tail']:.6f} "
          f"at tau {bench['speedup_tau']}); tail_loss_within_sync_band "
          f"{out['tail_loss_within_sync_band']} (BENCH "
          f"{bench['tail_loss_within_sync_band']}); {secs:.3f} s; launches "
          f"{launches}")
    if not ok:
        raise AssertionError("[pipeline_bench] a run broke a gate")
    return launches


class round_events:
    """Inside the block, every round engine that ``rounds`` builds records
    a CUDA event after each commit (and ``start()`` one before the
    rounds), so the device time of each round reads as the time between
    two events whatever ``flush_every`` lets the host run ahead; no event
    is waited for before the drain."""

    def __enter__(self):
        from repro_torch.dist import rounds

        self.mod, self.real = rounds, rounds.make_pipelined_round_fn
        self.events = []

        def make(*a, **k):
            engine = self.real(*a, **k)
            commit = engine.commit

            def timed(*ca, **ck):
                out = commit(*ca, **ck)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                return out

            engine.commit = timed
            return engine

        rounds.make_pipelined_round_fn = make
        return self

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def seconds(self):
        """Device seconds of each round (after the rounds' drain)."""
        self.events[-1].synchronize()
        return [a.elapsed_time(b) / 1e3
                for a, b in zip(self.events, self.events[1:])]

    def __exit__(self, *exc):
        self.mod.make_pipelined_round_fn = self.real


def run_path(tag, cfg, tcfg, n, dev, need, check_h_sum, rounds_=3,
             forbid=(), keep=False, seq_len=128, batch=2, **kw):
    """Drive ``run_rounds`` for ``rounds_`` rounds of ``cfg`` at ``n``
    clients (``seq_len`` tokens, ``batch`` sequences per client) with the
    launch counts set to 0 just before and read just after; check finite
    losses, a launch of every kernel in ``need`` and none of ``forbid``
    and, if asked, sum_i h_i = 0 (printed in any case).  The metrics drain
    every round unless ``flush_every`` is given, so each row's ``seconds``
    holds its own wait for the card, as before the drain was batched; each
    round's device time (``round_events``) is printed beside it.  Returns
    the launch counts, and with ``keep`` also the state and the rows."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import comm_ws, model_api, rounds, tamuna_dp
    from repro_torch.kernels import _build

    d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    desc = [f"n={n} c={tcfg.c} s={tcfg.s} robust_agg={tcfg.robust_agg} "
            f"trim_k={tcfg.trim_k} wire_precision={tcfg.wire_precision} "
            f"wire_down={tcfg.wire_down} uplink={tcfg.uplink} local_opt="
            f"{tcfg.local_opt} microbatches={tcfg.microbatches} comm_impl="
            f"{tcfg.comm_impl}"]
    if "faults" in kw:
        fp = kw["faults"]
        desc.append(f"{fp.model} byzantine clients "
                    f"{np.flatnonzero(fp.byzantine).tolist()}")
    desc += [f"{k}={v}" for k, v in kw.items()
             if k not in ("faults", "plan", "reputation")]
    if "reputation" in kw:
        rep = kw["reputation"]
        desc.append(f"Reputation(threshold={rep.threshold}, alpha="
                    f"{rep.alpha}, base_rounds={rep.base_rounds})")
    if "plan" in kw:
        desc.append("cohorts from CohortPlan(0, n, c)")
    print(f"[{tag}] " + ", ".join(desc))
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=seq_len, per_client_batch=batch, vocab=512,
                   seed=0, n_clients=n), cfg, dev)
    kw.setdefault("flush_every", 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with round_events() as evs:
        evs.start()
        state, rows = rounds.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=rounds_,
            rng=np.random.default_rng(0),
            generator=torch.Generator().manual_seed(1), max_L=4, **kw)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for row, sec in zip(rows, evs.seconds()):
        row["device_s"] = sec
    fault_keys = ("arrivals", "corrupted", "retries", "backoff_s",
                  "quorum_miss", "round_latency_s", "anomaly_max")
    for row in rows:
        extra = " ".join(f"{k} {row[k]:.6g}" for k in fault_keys if k in row)
        print(f"[{tag}] round {row['round']}: L={row['L']} loss "
              f"{row['loss']:.6f} wall {row['seconds']:.3f} s device "
              f"{row['device_s']:.3f} s up_floats "
              f"{row['up_floats']:.0f} down_floats {row['down_floats']:.0f} "
              f"up_bytes {row['up_bytes']:.0f} down_bytes "
              f"{row['down_bytes']:.0f}" + (f" {extra}" if extra else ""))
    print(f"[{tag}] launches {launches}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"[{tag}] non-finite loss: {rows}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"[{tag}] a kernel of {need} was not "
                             f"launched: {launches}")
    if any(launches[k] for k in forbid):
        raise AssertionError(f"[{tag}] a kernel of {forbid} was launched: "
                             f"{launches}")
    ratio = h_sum_ratio(state.h, d)
    print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e}"
          + (" (limit 1e-4)" if check_h_sum else " (not gated)"))
    if check_h_sum:
        if not ratio <= 1e-4:
            raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: ratio "
                                 f"{ratio}")
    del pipe
    if keep:
        return launches, state, rows
    del state
    torch.cuda.empty_cache()
    return launches


class count_plain_attention:
    """Counts the calls of the two plain attentions of the decode path
    (the model's ``_decode_scores_dyn`` and the kernel's plain version
    ``ref.decode_attention``) inside the block."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import transformer

        self.calls = 0
        self.saved = [(transformer, "_decode_scores_dyn"),
                      (ref, "decode_attention")]
        self.fns = [getattr(m, a) for m, a in self.saved]

        def counted(fn):
            def wrapper(*args, **kw):
                self.calls += 1
                return fn(*args, **kw)
            return wrapper

        for (m, a), fn in zip(self.saved, self.fns):
            setattr(m, a, counted(fn))
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self.saved, self.fns):
            setattr(m, a, fn)


def kernel_attn(cfg) -> int:
    """Decode-kernel launches per token: ``n_attn``, but none for the
    encoder-decoder, whose decode takes no ``attend_fn`` (the reference's
    takes none either)."""
    return 0 if cfg.family == "encdec" else cfg.n_attn


def serve_inputs(cfg, batch: int, dev):
    """``launch.serve.run``'s ``attend_fn`` and ``frames`` keywords for
    ``cfg`` on ``dev``: the decode kernel, or the encoder-decoder's frames
    (``serve.make_frames``)."""
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.launch import serve

    if cfg.family == "encdec":
        return {"frames": serve.make_frames(batch, cfg, dev)}
    return {"attend_fn": make_attend_fn(cfg)}


def serve_params_on(cfg, dev, seed=0):
    """Random parameters from ``seed`` on ``dev``, cast once for serving
    (the f32 originals freed)."""
    from repro_torch.dist import model_api
    from repro_torch.serve_utils import cast_for_serving_

    params = model_api.init(cfg, seed=seed, device=dev)
    cast_for_serving_(params, cfg)
    torch.cuda.empty_cache()
    return params


def serve_with_snapshot(params, cfg, prompts, gen_len, kv_dtype,
                        attend_fn=None, frames=None) -> dict:
    """``serve.run``'s greedy batch, driven through ``serve_utils.generate``
    with a copy of the cache taken just after the second-last step
    (``snapshot``: the recurrent states the last step starts from);
    ``serve.run``'s ``tokens``, ``logits``, ``cache`` and ``finite``."""
    from repro_torch.dist import model_api
    from repro_torch.launch import serve
    from repro_torch.serve_utils import generate

    b, plen = prompts.shape
    cache = model_api.make_cache(cfg, b, plen + gen_len, kv_dtype=kv_dtype,
                                 device=prompts.device)
    if frames is not None:
        serve.fill_cross_kv(params, cfg, cache, frames)
    finite = torch.ones((), dtype=torch.bool, device=prompts.device)
    seen = {}

    def on_step(pos, logits):
        finite.logical_and_(torch.isfinite(logits).all())
        seen["logits"] = logits
        if pos == plen + gen_len - 2:
            seen["snapshot"] = {k: v.clone() for k, v in cache.items()}

    with torch.no_grad():
        tokens, cache = generate(params, cfg, prompts, gen_len,
                                 temperature=0.0, cache=cache,
                                 attend_fn=attend_fn, on_step=on_step)
    return {"tokens": tokens, "logits": seen["logits"], "cache": cache,
            "finite": bool(finite), "snapshot": seen["snapshot"]}


def rerun_last_step(params, cfg, res, prompts, device, attend_fn,
                    cache=None):
    """The served batch's last decode step again, on ``device`` from a
    copy of ``cache``, by default the final cache (the step rewrites its
    own K/V row at the last position and attends to the same earlier rows:
    the same step for an attention-only model; the recurrent states of the
    other families need the cache from before the step, ``res["snapshot"]``
    of ``serve_with_snapshot``): ``(logits, cache)``."""
    from repro_torch.dist import model_api

    pos = prompts.shape[1] + res["tokens"].shape[1] - 1
    src = res["cache"] if cache is None else cache
    cache = {k: v.to(device, copy=True) for k, v in src.items()}
    p = params if device == res["logits"].device else {
        k: v.to(device) for k, v in params.items()}
    with torch.no_grad():
        return model_api.decode(p, cfg, res["tokens"][:, -1:].to(device),
                                cache, pos, attend_fn=attend_fn)


def run_serve_reduced(dev) -> dict:
    """``[serve_reduced]``: each of SERVE_REDUCED_ARCHS' reduced configs
    (f32 compute; gemma2-2b's window of 64, stablelm-3b's biases and
    untied head, deepseek-coder-33b's GQA 8:2 at head_dim 32,
    internvl2-26b's untied head) served for SERVE_REDUCED on the card
    (through the kernel) and on the CPU (the model's plain attention),
    with the same prompts and weights (and frames: whisper-tiny's decode
    takes no kernel).  On an f32 cache the greedy tokens
    must be equal and every logit of the last step within 1e-4 of the
    largest; on a bf16 cache (the CLI's) the last step is rerun on the CPU
    from the card's own final cache and held to the same 1e-4 (run through
    many steps, one-ulp roundings of the cache compound).  Returns the
    launch counts, summed over the configs."""
    launches = None
    for arch in SERVE_REDUCED_ARCHS:
        got = serve_reduced_one(arch, dev)
        launches = got if launches is None else {
            k: launches[k] + got[k] for k in launches}
    return launches


def serve_reduced_one(arch: str, dev) -> dict:
    """``[serve_reduced]`` for one architecture's reduced config."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    cfg = registry.get_reduced_config(arch)
    sr = SERVE_REDUCED
    params = serve_params_on(cfg, dev)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    prompts = serve.make_prompts(sr["batch"], sr["prompt_len"], cfg.vocab,
                                 0, "cpu")
    card_kw = serve_inputs(cfg, sr["batch"], dev)
    cpu_kw = ({"frames": card_kw["frames"].cpu()} if "frames" in card_kw
              else {})
    print(f"[serve_reduced] {cfg.name} ({cfg.family}, f32, window "
          f"{cfg.sliding_window}, head_dim {cfg.head_dim_}, "
          f"{cfg.n_heads}:{cfg.n_kv_heads} heads, q/k/v biases "
          f"{cfg.qkv_bias}, tied head {cfg.tie_embeddings}, {cfg.n_attn} "
          f"attentions per token), batch {sr['batch']}, prompt "
          f"{sr['prompt_len']}, gen {sr['gen_len']}: card (kernel) vs CPU "
          f"(plain attention)")
    launches = dict.fromkeys(_build.launch_counts, 0)
    steps = sr["prompt_len"] + sr["gen_len"]
    with intra_op_threads(REDUCED_CPU_THREADS):
        for kv in (torch.float32, torch.bfloat16):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            # the bf16 cache's last step is rerun from the cache before it
            drive = serve.run if kv == torch.float32 else serve_with_snapshot
            with count_plain_attention() as plain:
                card = drive(params, cfg, prompts.to(dev), sr["gen_len"],
                             kv_dtype=kv, **card_kw)
            got = {k: v for k, v in _build.launch_counts.items() if v}
            for k, v in got.items():
                launches[k] += v
            name = ("decode_attention_f32" if kv == torch.float32
                    else "decode_attention_f32_bf16kv")
            want_launches = ({name: kernel_attn(cfg) * steps}
                             if kernel_attn(cfg) else {})
            if got != want_launches or plain.calls:
                raise AssertionError(f"[serve_reduced] {arch} {kv} cache: "
                                     f"launches "
                                     f"{got}, plain attention calls "
                                     f"{plain.calls}")
            states = ""
            if kv == torch.float32:
                cpu = serve.run(params_cpu, cfg, prompts, sr["gen_len"],
                                kv_dtype=kv, **cpu_kw)
                want, same = cpu["logits"], torch.equal(
                    card["tokens"].cpu(), cpu["tokens"])
            else:
                want, cache = rerun_last_step(params_cpu, cfg, card, prompts,
                                              "cpu", None, card["snapshot"])
                pos = steps - 1
                same = all(bf16_ulps(cache[n][:, :, pos],
                                     card["cache"][n][:, :, pos].cpu()) <= 1
                           for n in ("k", "v") if n in cache)
                # the recurrent states after the step, card vs CPU
                errs = {n: float((cache[n] - card["cache"][n].cpu()).abs()
                                 .max() / cache[n].abs().max().clamp(
                                     min=1e-30))
                        for n in cache if n not in ("k", "v", "xk", "xv")}
                if errs:
                    states = (" recurrent states after the step within "
                              f"{max(errs.values()):.3e} of their largest "
                              f"(tolerance 1e-4) {errs};")
                    same = same and max(errs.values()) <= 1e-4
            err = float((card["logits"].cpu() - want).abs().max()
                        / want.abs().max())
            print(f"[serve_reduced] {arch} {kv} cache: {got}; last logits "
                  f"card vs "
                  f"CPU {err:.3e} of the largest (tolerance 1e-4); "
                  + ("greedy tokens equal" if kv == torch.float32 else
                     "rows written at the last step within one bf16 ulp")
                  + f":{states} {same}; continuations "
                  f"{card['tokens'][:2].tolist()}")
            if not (card["finite"] and err <= 1e-4 and same):
                raise AssertionError(f"[serve_reduced] {arch} {kv} cache: "
                                     f"err {err}, match {same}")
    return launches


def profile_last_steps(tag, params, cfg, res, prompts, dev, attend_fn,
                       reps: int = 3) -> None:
    """The served batch's last decode step run ``reps`` more times under
    ``torch.profiler`` (after one warm-up): wall time per step, the
    device's busy time per step (the sum of the kernels' device times)
    and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    rerun_last_step(params, cfg, res, prompts, dev, attend_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            rerun_last_step(params, cfg, res, prompts, dev, attend_fn)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / reps / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    attn = [e for e in rows if "decode_attn" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / reps / 1e3
    print(f"[{tag}] profiled step (last step rerun {reps} times, cache "
          f"copy included): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.1%}); decode_attention "
          f"{attn_ms:.4f} ms in {sum(e.count for e in attn) // reps} "
          f"launches ({attn_ms / max(cfg.n_attn, 1) * 1e3:.2f} us of "
          f"device time per attention); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / reps / 1e3:.3f}"
                      f" ms x{e.count // reps}" for e in top))


def run_serve(dev, tag: str = "serve", arch: str = "gemma2-2b",
              sv: dict = SERVE, layers=None) -> dict:
    """``[serve]``: gemma2-2b (``[serve_stablelm]``: stablelm-3b, head_dim
    80; ``[serve_moe]``, ``[serve_qwen3]``, ``[serve_rwkv]``,
    ``[serve_zamba2]``, ``[serve_whisper]``: the other families) at
    published widths and full depth (or ``layers``) through
    ``launch.serve.run``: ``sv``'s batch, prompt and generation on a bf16
    cache, the parameters cast to bf16 once (``cast_for_serving_``, leaf
    by leaf); whisper-tiny first encodes its frames into the cross K/V
    (timed apart).  Gates: finite logits at every step, ``kernel_attn x
    (prompt + gen)`` decode-kernel launches (none for RWKV-6 and
    whisper-tiny) and no call of the decode path's plain attentions."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    full = registry.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    steps = sv["prompt_len"] + sv["gen_len"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = serve_params_on(cfg, dev)
    init_peak = torch.cuda.max_memory_allocated()
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    count = sum(v.numel() for v in params.values())
    prompts = serve.make_prompts(sv["batch"], sv["prompt_len"], cfg.vocab, 0,
                                 dev)
    row_b = 2 * cfg.n_attn * cfg.n_kv_heads * cfg.head_dim_ * 2
    cache_b = row_b * sv["batch"] * (steps + cfg.n_frames)
    kw = serve_inputs(cfg, sv["batch"], dev)
    print(f"[{tag}] {cfg.name} ({cfg.family}), {cfg.n_layers} layers at "
          f"published widths"
          + ("" if layers is None else
             f" (depth cut {full.n_layers} -> {layers})")
          + f" (head_dim {cfg.head_dim_}, {cfg.n_heads}:{cfg.n_kv_heads} "
          f"heads, {cfg.n_attn} attentions per token), {count} parameters, "
          f"{nbytes} B for serving (f32 init and cast peak {init_peak} B); "
          f"batch {sv['batch']}, prompt {sv['prompt_len']}, gen "
          f"{sv['gen_len']}, bf16 K/V cache {cache_b} B ({row_b} B per "
          f"token" + (f", {cfg.n_frames} cross rows per sequence"
                      if cfg.n_frames else "") + ")")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with count_plain_attention() as plain:
        res = serve.run(params, cfg, prompts, sv["gen_len"],
                        kv_dtype=torch.bfloat16, **kw)
    counts = dict(_build.launch_counts)
    launches = {k: v for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    dt = res["prefill_s"] + res["decode_s"]
    if "frames" in kw:
        print(f"[{tag}] encoder over {cfg.n_frames} frames and the cross "
              f"K/V of {cfg.n_layers} layers, batch {sv['batch']}: "
              f"{res['encode_s'] * 1e3:.3f} ms")
    print(f"[{tag}] {steps} decode steps: prefill {res['prefill_s']:.3f} s "
          f"({res['prefill_s'] / sv['prompt_len'] * 1e3:.3f} ms per step), "
          f"generation {res['decode_s']:.3f} s "
          f"({res['decode_s'] / sv['gen_len'] * 1e3:.3f} ms per step, "
          f"{sv['batch'] * sv['gen_len'] / res['decode_s']:.1f} tok/s); "
          f"{sv['batch'] * steps / dt:.1f} tok/s over all steps")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"[{tag}] launches {launches}, plain attention calls "
          f"{plain.calls}, logits finite {res['finite']}")
    print(f"[{tag}] sample continuations: {res['tokens'][:2].tolist()}")
    profile_last_steps(tag, params, cfg, res, prompts, dev,
                       kw.get("attend_fn"))
    want = ({"decode_attention": kernel_attn(cfg) * steps}
            if kernel_attn(cfg) else {})
    if not res["finite"] or plain.calls or launches != want:
        raise AssertionError(f"[{tag}] finite {res['finite']}, launches "
                             f"{launches} (want {want}), plain calls "
                             f"{plain.calls}")
    del params, res
    torch.cuda.empty_cache()
    return counts


def run_serve_long(dev) -> dict:
    """``[serve_long]``: gemma2-2b at published widths cut to 2 layers
    (one local, one global) served past the 4096 window: SERVE_LONG's
    batch, prompt and generation on a bf16 cache.  Gates: finite logits,
    ``2 x (prompt + gen)`` launches, no plain attention, and the last
    step rerun on the card from the same cache with the kernel's plain
    version (within 1e-2 of the largest logit: the two round the
    attention output to bf16 apart by at most one ulp, which the next
    layer carries on) and with the model's plain attention (within 5e-2:
    it also rounds the probabilities to bf16); a step that drops the local
    layer's window is printed beside them.  Returns the launch counts."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.launch import serve

    cfg = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
    sl = SERVE_LONG
    steps = sl["prompt_len"] + sl["gen_len"]
    params = serve_params_on(cfg, dev)
    prompts = serve.make_prompts(sl["batch"], sl["prompt_len"], cfg.vocab, 0,
                                 dev)
    print(f"[serve_long] {cfg.name} at published widths cut to "
          f"{cfg.n_layers} layers (windows {cfg.layer_windows()}), batch "
          f"{sl['batch']}, prompt {sl['prompt_len']}, gen {sl['gen_len']}, "
          f"bf16 cache of {steps} rows")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with count_plain_attention() as plain:
        res = serve.run(params, cfg, prompts, sl["gen_len"],
                        kv_dtype=torch.bfloat16,
                        attend_fn=make_attend_fn(cfg))
    counts = dict(_build.launch_counts)
    launches = {k: v for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve_long] prefill {res['prefill_s']:.3f} s "
          f"({res['prefill_s'] / sl['prompt_len'] * 1e3:.3f} ms per step), "
          f"generation {res['decode_s']:.3f} s "
          f"({res['decode_s'] / sl['gen_len'] * 1e3:.3f} ms per step); "
          f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
          f"launches {launches}, plain attention calls {plain.calls}")

    def kernel_plain(q, k, v, pos, window):
        return ref.decode_attention(q[:, 0], k, v, pos, window=window,
                                    softcap=cfg.attn_softcap)[:, None]

    def no_window(q, k, v, pos, window):
        return kernel_plain(q, k, v, pos, None)

    profile_last_steps("serve_long", params, cfg, res, prompts, dev,
                       make_attend_fn(cfg))
    top = res["logits"].abs().max()
    errs = {}
    for tag, fn in (("kernel's plain version", kernel_plain),
                    ("model's plain attention", None),
                    ("without the local window", no_window)):
        lg, _ = rerun_last_step(params, cfg, res, prompts, dev, fn)
        errs[tag] = float((lg - res["logits"]).abs().max() / top)
    print(f"[serve_long] last step (pos {steps - 1}) rerun from the same "
          f"cache on the card, max logit difference over the largest: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (tolerances 1e-2 and 5e-2 for the first two)")
    if not (res["finite"] and not plain.calls
            and launches == {"decode_attention": cfg.n_layers * steps}
            and errs["kernel's plain version"] <= 1e-2
            and errs["model's plain attention"] <= 5e-2):
        raise AssertionError(f"[serve_long] finite {res['finite']}, launches "
                             f"{launches}, plain calls {plain.calls}, errs "
                             f"{errs}")
    del params, res
    torch.cuda.empty_cache()
    return counts


def run_serve_paths(dev) -> dict:
    """The serving paths, launch counts set to 0 just before each and read
    just after; returns them by path."""
    return {"serve_reduced": run_serve_reduced(dev),
            "serve": run_serve(dev),
            "serve_stablelm": run_serve(dev, "serve_stablelm", "stablelm-3b",
                                        SERVE_STABLELM),
            "serve_long": run_serve_long(dev),
            "serve_moe": run_serve(dev, "serve_moe", "qwen2-moe-a2.7b",
                                   SERVE_FAMILY),
            "serve_qwen3": run_serve(dev, "serve_qwen3", "qwen3-moe-30b-a3b",
                                     SERVE_FAMILY, SERVE_QWEN3_LAYERS),
            "serve_rwkv": run_serve(dev, "serve_rwkv", "rwkv6-7b",
                                    SERVE_FAMILY),
            "serve_zamba2": run_serve(dev, "serve_zamba2", "zamba2-2.7b",
                                      SERVE_FAMILY),
            "serve_whisper": run_serve(dev, "serve_whisper", "whisper-tiny",
                                       SERVE_WHISPER)}


def long_config():
    """gemma2-2b at published widths cut to 2 layers, ``remat`` on (the
    default): the config of ``[train_long]`` and the memory table."""
    from repro_torch.configs import gemma2_2b

    return dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)


def run_train_long(dev) -> dict:
    """``[train_long]``: ``[train]``'s round (n=4, c=3, s=2, gamma 0.05,
    p 0.34, 3 rounds, max_L 4) at LONG_SEQ tokens, 1 sequence per client,
    ``flush_every`` 10 (one drain at the last round), on ``long_config``:
    layer 0's 4096-token window cuts keys and the blockwise attention runs
    8 blocks of 1024 keys each way.  Each round's device time comes from
    ``round_events``.  Gated as ``[train]``, but for sum_i h_i = 0, gated
    as ``[train_whisper]``'s on each leaf's f32 rounding bound
    (``tamuna_dp.h_sum_rounding``), with its control, a lost owner planted
    in a fourth round (``planted_lost_owner``): ``|sum_i h_i| / max|h|``
    reads about 1.07e-4 here (printed), at the LM paths' 1e-4."""
    from repro_torch.dist import tamuna_dp
    from repro_torch.models import layers

    cfg = long_config()
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    print(f"[train_long] {cfg.name} 2 layers at published widths, "
          f"{LONG_SEQ} tokens, 1 sequence per client, remat {cfg.remat}, "
          f"windows {cfg.layer_windows()}, blockwise attention from "
          f"{layers.FLASH_THRESHOLD} tokens")
    t0 = time.perf_counter()
    out, state, rows = run_path(
        "train_long", cfg, tcfg, N, dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=False, keep=True, seq_len=LONG_SEQ, batch=1,
        flush_every=10)
    share, ulps, leaf = tamuna_dp.h_sum_rounding(state, tcfg, N, len(rows))
    print(f"[train_long] worst leaf's |sum_i h_i| against its f32 rounding "
          f"bound after {len(rows)} rounds: {share:.4f} of it, {ulps:.4f} "
          f"ulps of its max|x| ({leaf}); gate {H_SUM_HEADROOM} of it")
    if not share <= H_SUM_HEADROOM:
        raise AssertionError(f"[train_long] sum_i h_i = 0 beyond f32 "
                             f"rounding: {share} of the bound on {leaf}")
    planted_lost_owner("train_long", state, cfg, tcfg, N, len(rows), dev,
                       seq_len=LONG_SEQ, batch=1)
    del state
    torch.cuda.empty_cache()
    print(f"[train_long] phase {time.perf_counter() - t0:.1f} s")
    return out


def loss_and_grads_timed(cfg, params, tokens, labels, reps: int = 2):
    """One loss and gradient of ``cfg`` (``reps`` times, the last timed and
    its peak taken): ``(loss, grads, seconds, peak bytes)``.  The peak
    counts the parameters, their gradients and whatever autograd keeps."""
    from repro_torch.dist import model_api

    for i in range(reps):
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = model_api.loss(ps, cfg, tokens=tokens, labels=labels)
        grads = torch.autograd.grad(loss, list(ps.values()))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del ps
        if i + 1 < reps:
            del loss, grads
    return loss.detach(), grads, sec, peak


class chunk_loop_attention:
    """Inside the block ``layers.attention`` takes the blockwise
    attention's plain chunk loop, differentiated by autograd through the
    chunks, in place of the recomputing Function."""

    def __enter__(self):
        from repro_torch.models import layers

        self.real = layers.flash_attention
        layers.flash_attention = layers.flash_attention_plain

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.flash_attention = self.real


def long_inputs(cfg, dev, seq: int = None):
    seq = seq or LONG_SEQ
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, 512, (1, seq + 1), generator=g, device=dev)
    return toks[:, :-1], toks[:, 1:]


def memory_rows(dev, variants=("function", "chunk_loop")) -> list:
    """The memory table's rows for ``variants`` of the attention past 2048
    tokens (the recomputing Function, autograd through the chunk loop, or
    ``dense``: what this process's ``FLASH_THRESHOLD`` gives, the dense
    path under ``REPRO_DISABLE_FLASH=1``), each with ``remat`` on and off:
    one loss and gradient of ``long_config`` at LONG_SEQ tokens, 1
    sequence, its peak memory and seconds.  Prints each row as ``[memory]
    row {json}``."""
    from repro_torch.dist import model_api
    from repro_torch.models import layers

    base = long_config()
    params = model_api.init(base, seed=0, device=dev)
    tokens, labels = long_inputs(base, dev)
    rows = []
    for variant in variants:
        if variant == "dense" and layers.FLASH_THRESHOLD <= LONG_SEQ:
            raise AssertionError("the dense variant needs "
                                 "REPRO_DISABLE_FLASH=1")
        for remat in (True, False):
            cfg = dataclasses.replace(base, remat=remat)
            if variant == "chunk_loop":
                with chunk_loop_attention():
                    loss, grads, sec, peak = loss_and_grads_timed(
                        cfg, params, tokens, labels)
            else:
                loss, grads, sec, peak = loss_and_grads_timed(
                    cfg, params, tokens, labels)
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"[memory] {variant} remat {remat}: "
                                     f"loss {loss}")
            row = {"attention": variant, "remat": remat, "layers": 2,
                   "seq": LONG_SEQ, "peak_bytes": peak,
                   "peak_gib": peak / 2 ** 30, "seconds": sec,
                   "loss": float(loss)}
            rows.append(row)
            print(f"[memory] row {json.dumps(row)}")
            del loss, grads
            torch.cuda.empty_cache()
    return rows


def run_memory_table(dev, here: str) -> dict:
    """The model-only memory table at ``long_config``'s widths, 2 layers,
    LONG_SEQ tokens, 1 sequence: peak memory and seconds of one loss and
    gradient for ``remat`` on and off against the recomputing Function,
    autograd through the plain chunk loop, and the dense path (in a fresh
    process with ``REPRO_DISABLE_FLASH=1``, through ``smoke_phases.py``);
    one loss and gradient at full depth (26 layers) with ``remat`` and
    the Function; and on the card, at 2 layers and LONG_SEQ tokens, the
    Function's gradients against autograd through the chunk loop in f32
    compute (within LONG_GRAD_TOL of each leaf's largest gradient) and
    ``remat`` on against off in the main path's bf16 compute (bitwise, or
    the difference printed)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import model_api

    t0 = time.perf_counter()
    rows = memory_rows(dev)
    torch.cuda.empty_cache()
    env = dict(os.environ, REPRO_DISABLE_FLASH="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "smoke_phases.py"), "--tree",
         here, "--phase", "memory_dense"], env=env, capture_output=True,
        text=True)
    dense = [json.loads(line.split("[memory] row ", 1)[1])
             for line in proc.stdout.splitlines()
             if line.startswith("[memory] row ")]
    if proc.returncode != 0 or len(dense) != 2:
        raise AssertionError(f"[memory] the dense process failed "
                             f"({proc.returncode}):\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    rows += dense
    for r in rows:
        print(f"[memory] {r['attention']:>10} remat {str(r['remat']):>5}: "
              f"peak {r['peak_gib']:.2f} GiB, {r['seconds']:.3f} s per "
              f"loss and gradient, loss {r['loss']:.6f}")

    full = gemma2_2b.CONFIG
    params = model_api.init(full, seed=0, device=dev)
    tokens, labels = long_inputs(full, dev)
    loss, grads, sec, peak = loss_and_grads_timed(full, params, tokens,
                                                  labels, 1)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"[memory] full depth: loss {loss}")
    print(f"[memory] full depth ({full.n_layers} layers), remat "
          f"{full.remat}, the Function, {LONG_SEQ} tokens: peak "
          f"{peak / 2 ** 30:.2f} GiB ({peak} B), {sec:.3f} s per loss and "
          f"gradient, loss {float(loss):.6f}")
    rows.append({"attention": "function", "remat": True,
                 "layers": full.n_layers, "seq": LONG_SEQ,
                 "peak_bytes": peak, "peak_gib": peak / 2 ** 30,
                 "seconds": sec, "loss": float(loss)})
    del params, grads, loss
    torch.cuda.empty_cache()

    # the gradients on the card: the Function against the chunk loop (f32
    # compute), remat on against off (bf16 compute)
    base = long_config()
    params = model_api.init(base, seed=0, device=dev)
    tokens, labels = long_inputs(base, dev)
    f32 = dataclasses.replace(base, dtype=torch.float32)
    _, g_fn, _, _ = loss_and_grads_timed(f32, params, tokens, labels, 1)
    with chunk_loop_attention():
        _, g_loop, _, _ = loss_and_grads_timed(f32, params, tokens, labels,
                                               1)
    worst = (0.0, "")
    for name, a, b in zip(params, g_fn, g_loop):
        r = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, (r, name))
    del g_fn, g_loop
    print(f"[memory] f32 gradients, the Function against autograd through "
          f"the chunk loop: worst leaf {worst[1]} at {worst[0]:.3e} of its "
          f"largest gradient (tolerance {LONG_GRAD_TOL})")
    if not worst[0] <= LONG_GRAD_TOL:
        raise AssertionError(f"[memory] Function vs chunk loop: {worst}")
    out = []
    for remat in (True, False):
        out.append(loss_and_grads_timed(
            dataclasses.replace(base, remat=remat), params, tokens, labels,
            1)[:2])
    (l1, g1), (l0, g0) = out
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(g1, g0))
    same = bool(torch.equal(l1, l0)) and all(
        torch.equal(a, b) for a, b in zip(g1, g0))
    print(f"[memory] bf16 compute, remat on against off: loss "
          f"{float(l1)!r} vs {float(l0)!r}, gradients bitwise {same} (max "
          f"abs difference {diff})")
    if not bool(torch.isfinite(l1)):
        raise AssertionError("[memory] remat: non-finite loss")
    del out, g1, g0, params
    torch.cuda.empty_cache()
    print(f"[memory] phase {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "function_vs_loop": worst[0],
            "remat_bitwise": same, "remat_max_diff": diff}


def run_sync_check(cfg, dev) -> dict:
    """``[sync]``: ``[train]``'s fault-free rounds (n=4, c=3, s=2, 3
    rounds) with ``flush_every`` 3 under
    ``torch.cuda.set_sync_debug_mode("warn")``, every warning recorded:
    the synchronising calls inside the drains (``rounds._drain``) and
    between them, with the call sites of the latter; fails on any between
    drains.  (Setting the mode prints a notice that it is a prototype:
    only "called a synchronizing CUDA operation" warnings count.)"""
    import traceback
    import warnings

    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, tamuna_dp

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=N), cfg, dev)
    torch.cuda.synchronize()
    drain = rounds._drain
    marks, caught = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        # the repository's innermost frame that led to the warning
        here = os.path.dirname(os.path.abspath(__file__))
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(here)
                  and not f.filename.endswith("chip_smoke.py")]
        site = (f"{os.path.relpath(frames[-1].filename, here)}:"
                f"{frames[-1].lineno} {frames[-1].name}" if frames
                else f"{filename}:{lineno}")
        caught.append((str(message), site, time.perf_counter()))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show

        def marked(pending, *rest):
            a = len(caught)
            drain(pending, *rest)
            marks.append((a, len(caught)))

        rounds._drain = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, rows = rounds.run_rounds(
                state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=3,
                rng=np.random.default_rng(0),
                generator=torch.Generator().manual_seed(1), max_L=4,
                flush_every=3)
            returned = len(caught)
        finally:
            # switching the mode off may itself warn: not a round's
            torch.cuda.set_sync_debug_mode(0)
            rounds._drain = drain
    syncs = [i for i, (msg, _, _) in enumerate(caught[:returned])
             if "called a synchronizing CUDA operation" in msg]
    in_drain = {i for a, b in marks for i in range(a, b)}
    outside = [caught[i] for i in syncs if i not in in_drain]
    sites = {}
    for msg, site, _ in outside:
        sites[f"{site}: {msg[:80]}"] = sites.get(f"{site}: {msg[:80]}", 0) + 1
    print(f"[sync] {len(rows)} rounds (L {[r['L'] for r in rows]}) with "
          f"flush_every 3: {len(marks)} drain(s) with "
          f"{len(syncs) - len(outside)} synchronising call(s) inside; "
          f"{len(outside)} between drains (target 0): {sites}; "
          f"{len(caught) - returned} warning(s) after run_rounds returned "
          f"(the debug mode's own switch)")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"[sync] non-finite loss: {rows}")
    if outside or len(marks) != 1:
        raise AssertionError(f"[sync] {len(outside)} synchronising calls "
                             f"between drains: {sites}")
    del state, pipe
    torch.cuda.empty_cache()
    return {"between_drains": len(outside), "sites": sites,
            "drains": len(marks)}


def run_examples() -> dict:
    """``[examples]``: each of EXAMPLES' ``main`` on the card (the
    examples' default device), in this process, its standard output kept
    and its last lines printed (and its standard error's, when it does not
    return 0); the launch counts set to 0 before the first and read after
    the last.  Gate: every ``main`` returns 0."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_all, failed = time.perf_counter(), []
    for name, argv in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = mod.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tail = [ln for ln in buf.getvalue().splitlines() if ln.strip()][-3:]
        print(f"[examples] {name} {' '.join(argv)}: exit {rc} in {dt:.2f} s; "
              + " | ".join(tail))
        if rc != 0:
            print(f"[examples] {name} standard error: "
                  + " | ".join(err.getvalue().splitlines()[-10:]))
            failed.append((name, argv, rc))
    counts = dict(_build.launch_counts)
    print(f"[examples] {len(EXAMPLES)} runs in "
          f"{time.perf_counter() - t_all:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if failed:
        raise AssertionError(f"[examples] non-zero exits: {failed}")
    return counts


# --------------------------------------------------------------------------
# data parallelism: [train_dp], [comm_dp], [faults_dp] on two gloo ranks on
# the one card, [dp_nccl] on a one-rank nccl group (ROADMAP A9a)
# --------------------------------------------------------------------------


class smi_peak:
    """Inside the block, a thread reads the card's memory in use
    (``nvidia-smi``) every half second; ``peak`` is the largest reading,
    MiB, every process's on the card included."""

    def __enter__(self):
        import threading

        self.peak, self.done = 0, threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True)
            if out.returncode == 0 and out.stdout.strip():
                self.peak = max(self.peak, int(out.stdout.split()[0]))
            self.done.wait(0.5)

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()


def finite_absmax(ws: torch.Tensor, chunk: int = 1 << 25) -> float:
    """max |ws| over its finite entries, in column chunks."""
    top = 0.0
    for a in range(0, ws.shape[1], chunk):
        v = ws[:, a:a + chunk].abs()
        top = max(top, float(torch.where(torch.isfinite(v), v, 0.0).max()))
    return top


def f32_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 23) if v > 0 else 2.0 ** -149


def comm_dp_steps(cfg, x, h, dev, group=None) -> dict:
    """``[comm_dp]``'s comm steps (``COMM_DP``, in order, the robust ones
    last) in place on the rows ``x``/``h`` hold (a rank's under
    ``group``), each from the state the one before left (the first from
    ``[train]``'s; no copy of the state is kept): ``{tag: (x digests, h
    digests, seconds, largest collective)}``, the robust steps' digests up
    to the sign of zero."""
    from repro_torch.dist import tamuna_dp

    out = {}
    for tag, c, s, kw, cohort_, perm, arrived in COMM_DP:
        tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **kw)
        step = tamuna_dp.make_comm_step(cfg, tcfg, N, device=dev,
                                        group=group)
        state = tamuna_dp.DistTamunaState(
            x=x, h=h, spec=tamuna_dp.state_spec(cfg, tcfg))
        n_sums = 0 if group is None else len(group.sizes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, cohort_, perm, np.asarray(COMM_DP_DOWN),
             None if arrived is None else np.asarray(arrived), True,
             COMM_DP_SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del step  # its band tables
        zs = tcfg.robust_() is not None
        out[tag] = (row_digests(x, zero_sign=zs), row_digests(h, zero_sign=zs),
                    secs, 0 if group is None else max(group.sizes[n_sums:]))
    return out


def faults_dp_reference(cfg, dev, rows3, plan3) -> dict:
    """What ``[faults_dp]`` is held to: ``[faults]``' rows and quarantine
    windows (``rows3``, ``plan3``), and its state after round 1 from a
    one-process run of rounds 0-1: the rows' digests, each leaf's max|x|
    and the x_bar round 1 downloaded (one row, kept on the card for the
    ranks, which map it: every coordinate has an arrived owner in that
    round, so every downloaded row holds all of it; checked)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import cohort, faults, rounds, tamuna_dp

    tcfg_f = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P)
    fplan = faults.FaultPlan(seed=0, n=NF, p_drop=0.25, p_corrupt=0.2,
                             corrupt_mode="nan")
    state = tamuna_dp.init_state(cfg, tcfg_f, NF, seed=0, device=dev)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=NF), cfg, dev)
    plan = cohort.CohortPlan(0, NF, CF)
    state, _ = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg_f, pipe=pipe, rounds=2,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=4, flush_every=1,
        plan=plan, faults=fplan, policy="quorum", quarantine_rounds=2)
    # round 1's DownCom rows: round 2's cohort as the driver resolved it,
    # after round 0's quarantine
    resolve = rounds._make_fault_resolver(
        fplan, n=NF, policy="quorum", q=CF // 2 + 1, max_retries=3,
        backoff0=1.0, deadline=None,
        host_cohort=rounds._host_cohort(plan, 1, NF, CF))
    down = np.flatnonzero(resolve(2)["member"])
    xd = row_digests(state.x)
    if not all(np.array_equal(xd[i], xd[down[0]]) for i in down):
        raise AssertionError("[faults_dp] round 1 left a coordinate "
                             "uncovered: its downloaded rows differ")
    leaves = list(zip(state.spec.offsets, state.spec.dims))
    out = {"x0": xd, "h0": row_digests(state.h),
           "xbar": state.x[int(down[0])].clone(), "leaves": leaves,
           "leaf_max": [finite_absmax(state.x[:, o:o + D])
                        for o, D in leaves],
           "loss": [r["loss"] for r in rows3],
           "counts": [(r["arrivals"], r["corrupted"], r["retries"])
                      for r in rows3],
           "windows": [(ids.tolist(), a, b)
                       for ids, a, b in plan3._quarantine]}
    print(f"[faults_dp] [faults]' rounds 0-1 in one process: rows "
          f"{down.tolist()} downloaded x_bar, kept for the ranks "
          f"({out['xbar'].numel() * 4 / 2**30:.2f} GiB)")
    del state, pipe
    torch.cuda.empty_cache()
    return out


def dp_h_sum_ratio(h: torch.Tensor, g) -> float:
    """|sum_i h_i| / max|h| over every rank's rows: the column sums in
    chunks and each rank's max|h|, summed over the ranks through ``g``."""
    hsum = 0.0
    for a in range(0, h.shape[1], 1 << 27):
        col = h[:, a:a + (1 << 27)].sum(0)
        hsum = max(hsum, float(g.all_reduce(col).abs().max()))
    top = torch.zeros(g.world, dtype=torch.float32, device=h.device)
    top[g.rank] = h.abs().max()
    hmax = float(g.all_reduce(top).max())
    return hsum / hmax if hmax > 0 else math.inf


def dp_rank(rank: int, dev, cfg, job: dict, out_dir: str) -> None:
    """One of the ``DP_WORLD`` ranks of the data-parallel paths, on
    ``dev`` (cuda:0 for both) in a gloo group: ``[train_dp]`` (``[train]``
    over the ranks), ``[comm_dp]`` (``COMM_DP``'s comm steps on the state
    ``[train_dp]`` leaves), ``[faults_dp]`` (``[faults]`` over the ranks).
    Each gate compares the rank's rows with the one-process path's, from
    ``job`` (the parent's digests and rows; ``[faults]``'s state in shared
    host memory), and raises on a miss, which fails the spawn.  Writes its
    launch counts, peaks and collective sizes to ``out_dir``."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import cohort, faults, rounds, sharding, tamuna_dp
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    res = {"launches": {}, "peak": {}, "sums": {}}
    spec = tamuna_dp.state_spec(
        cfg, tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P))

    def drive(tag, tcfg, n, calls=(3,), between=None, **kw):
        """``run_rounds`` on this rank's rows in calls of ``calls`` rounds
        (the state, streams and plans carried over; ``between(state,
        rows)`` after the first of two), as ``run_path`` drives it."""
        g = sharding.RankRows.of_group(n)
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev,
                                     rows=g)
        pipe = SyntheticTokenPipeline(
            DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                       n_clients=n), cfg, dev)
        common = dict(cfg=cfg, tcfg=tcfg, pipe=pipe,
                      rng=np.random.default_rng(0),
                      generator=torch.Generator().manual_seed(1), max_L=4,
                      flush_every=1, group=g, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        rows, secs = [], []
        for i, k in enumerate(calls):
            with round_events() as evs:
                evs.start()
                state, more = rounds.run_rounds(state, rounds=k, **common)
            secs += evs.seconds()
            for row in more:  # each call counts its own local steps
                row["local_steps"] += rows[-1]["local_steps"] if rows else 0
            rows += more
            if between is not None and i == 0 and len(calls) > 1:
                between(state, rows)  # launches no kernel
        res["launches"][tag] = dict(_build.launch_counts)
        res["peak"][tag] = torch.cuda.max_memory_allocated()
        res["sums"][tag] = [list(g.sizes), list(g.seconds)]
        for row, sec in zip(rows, secs):
            extra = " ".join(f"{k} {row[k]:.6g}" for k in (
                "arrivals", "corrupted", "retries") if k in row)
            print(f"[{tag} rank {rank}] round {row['round']}: L={row['L']} "
                  f"loss {row['loss']:.6f} wall {row['seconds']:.3f} s "
                  f"device {sec:.3f} s {extra}", flush=True)
        print(f"[{tag} rank {rank}] rows {g.row0}..{g.stop - 1} of {n}; "
              f"all_reduce (elements, host s): "
              f"{[(z, round(t, 3)) for z, t in zip(g.sizes, g.seconds)]}; "
              f"peak {res['peak'][tag] / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in res['launches'][tag].items() if v} }",
              flush=True)
        if max(g.sizes) > spec.d_total:
            raise AssertionError(f"[{tag}] a collective of {max(g.sizes)} "
                                 f"elements > d_total {spec.d_total}")
        del pipe
        return state, rows, g

    # [train_dp]: bitwise [train] (row digests, every round's loss)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    state, rows, g = drive("train_dp", tcfg, N)
    mine = slice(g.row0, g.stop)
    ref = job["train"]
    same = (np.array_equal(row_digests(state.x), ref["x"][mine])
            and np.array_equal(row_digests(state.h), ref["h"][mine]))
    losses = [r["loss"] for r in rows]
    ratio = dp_h_sum_ratio(state.h, sharding.RankRows.of_group(N))
    print(f"[train_dp rank {rank}] x and h bitwise [train]'s rows "
          f"{g.row0}..{g.stop - 1} {same}; losses {losses} equal "
          f"{losses == ref['loss']}; |sum_i h_i| / max|h| over the ranks "
          f"{ratio:.3e} (limit 1e-4)", flush=True)
    if not (same and losses == ref["loss"] and ratio <= 1e-4):
        raise AssertionError(f"[train_dp] rank {rank} differs from [train]")

    # [comm_dp]: each step bitwise the one-process kernel step's
    g = sharding.RankRows.of_group(N)
    torch.cuda.empty_cache()  # the rounds' cached blocks
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    got = comm_dp_steps(cfg, state.x, state.h, dev, group=g)
    res["launches"]["comm_dp"] = dict(_build.launch_counts)
    res["peak"]["comm_dp"] = torch.cuda.max_memory_allocated()
    res["sums"]["comm_dp"] = [list(g.sizes), list(g.seconds)]
    for tag, c, s, _, _, _, _ in COMM_DP:
        gx, gh, secs, top = got[tag]
        wx, wh, ref_secs, _ = job["comm"][tag]
        ok = (np.array_equal(gx, wx[mine]) and np.array_equal(gh, wh[mine]))
        robust = tag in ("trimmed", "median")
        bound = s * min(spec.d_total, 1 << 24) if robust else spec.d_total
        print(f"[comm_dp rank {rank}] {tag} (c={c} s={s}): x and h bitwise "
              f"the one-process kernel step's"
              f"{' up to the sign of zero' if robust else ''} {ok}; "
              f"{secs:.3f} s (one process {ref_secs:.3f} s); largest "
              f"collective {top} elements (bound "
              f"{'s x chunk' if robust else 'd_total'} {bound}, d_total "
              f"{spec.d_total})", flush=True)
        if not ok or top > bound:
            raise AssertionError(f"[comm_dp] {tag} rank {rank} differs")
    print(f"[comm_dp rank {rank}] peak "
          f"{res['peak']['comm_dp'] / 2**30:.2f} GiB", flush=True)
    del state, got
    torch.cuda.empty_cache()

    # [faults_dp]: [faults] over the ranks, as 2 + 1 rounds.  Round 1's
    # comm step sums the ranks' survivor partials, which reassociates each
    # coordinate's three-term owner sum at s = 3 (round 0's has at most
    # two arrived owners a coordinate): rows that did not download are
    # bitwise, the downloaded x_bar within 2 ulps of each leaf's max|x|.
    # The local steps carry those ulps into every leaf, so round 2 is held
    # on its decisions and sum_i h_i = 0.
    ref = job["faults"]
    tcfg_f = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P)
    plan = cohort.CohortPlan(0, NF, CF)
    first = {}

    def round1(state, rows):
        g0 = sharding.RankRows(NF, DP_WORLD, rank)
        xd, hd = row_digests(state.x), row_digests(state.h)
        same, ulps = [], 0.0
        for j in range(g0.local):
            i = g0.row0 + j
            if np.array_equal(xd[j], ref["x0"][i]):
                same.append(i)
                continue
            for (o, D), top in zip(ref["leaves"], ref["leaf_max"]):
                d = (state.x[j, o:o + D] - ref["xbar"][o:o + D]).abs()
                ulps = max(ulps, float(d.max()) / f32_ulp(top))
        hsame = [g0.row0 + j for j in range(g0.local)
                 if np.array_equal(hd[j], ref["h0"][g0.row0 + j])]
        first.update(same=same, ulps=ulps, hsame=hsame,
                     loss=[r["loss"] for r in rows])

    state, rows, g = drive(
        "faults_dp", tcfg_f, NF, calls=(2, 1), between=round1, plan=plan,
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.25, p_corrupt=0.2,
                                corrupt_mode="nan"),
        policy="quorum", quarantine_rounds=2)
    counts = [(r["arrivals"], r["corrupted"], r["retries"]) for r in rows]
    windows = [(ids.tolist(), a, b) for ids, a, b in plan._quarantine]
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, ref["loss"])]
    ratio = dp_h_sum_ratio(state.h, sharding.RankRows.of_group(NF))
    print(f"[faults_dp rank {rank}] after round 1: rows {first['same']} "
          f"bitwise [faults]', the downloaded rows' x_bar within "
          f"{first['ulps']:.2f} ulps of each leaf's max|x| (limit 2), h "
          f"bitwise on rows {first['hsame']}, losses of rounds 0-1 bitwise "
          f"{first['loss'] == ref['loss'][:2]}; rounds 0-2: arrivals, guard verdicts, retries {counts} equal "
          f"{counts == ref['counts']}, quarantine windows {windows} equal "
          f"{windows == ref['windows']}, losses {[r['loss'] for r in rows]} "
          f"relative to [faults]' {[f'{v:.3e}' for v in rel]} (not gated), "
          f"|sum_i h_i| / max|h| over the ranks {ratio:.3e} (limit 1e-4)",
          flush=True)
    if not (first["ulps"] <= 2 and first["loss"] == ref["loss"][:2]
            and counts == ref["counts"] and windows == ref["windows"]
            and ratio <= 1e-4):
        raise AssertionError(f"[faults_dp] rank {rank} differs from "
                             "[faults]")
    del state, ref
    release_mapped(job, "faults")  # [faults]' x_bar, mapped from the parent
    torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def dp_nccl_rank(rank: int, dev, out_dir: str) -> None:
    """``[dp_nccl]``: the reduced gemma2-2b round (n=4, c=3, s=2, 3
    rounds, 64 tokens, 2 sequences, max_L 4) in one process and through a
    one-rank nccl group (``run_rounds(group=)``, the shard engine's sums
    on nccl), on the card: x, h (row digests) and every row bitwise.  It
    shows that the nccl path launches and takes its tensors; with one rank
    it partitions nothing."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, sharding, tamuna_dp
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)

    def run(group):
        state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev,
                                     rows=group)
        pipe = SyntheticTokenPipeline(
            DataConfig(seq_len=64, per_client_batch=2, vocab=512, seed=0,
                       n_clients=N), cfg, dev)
        _build.reset_launch_counts()
        state, rows = rounds.run_rounds(
            state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=3,
            rng=np.random.default_rng(0),
            generator=torch.Generator().manual_seed(1), max_L=4,
            flush_every=2, group=group)
        keys = ("round", "L", "loss", "local_steps", "up_floats",
                "down_floats", "up_bytes", "down_bytes")
        return (row_digests(state.x), row_digests(state.h),
                [[r[k] for k in keys] for r in rows],
                dict(_build.launch_counts))

    one = run(None)
    g = sharding.RankRows.of_group(N)
    grp = run(g)
    same = all(np.array_equal(a, b) for a, b in zip(one[:2], grp[:2]))
    print(f"[dp_nccl] reduced gemma2-2b, one rank on nccl: x and h bitwise "
          f"the one-process run {same}, rows equal {one[2] == grp[2]}; "
          f"all_reduce sizes {g.sizes}; launches "
          f"{ {k: v for k, v in grp[3].items() if v} } (it shows the nccl "
          f"path launches and takes the tensors; one rank partitions "
          f"nothing)", flush=True)
    if not (same and one[2] == grp[2] and g.sizes):
        raise AssertionError("[dp_nccl] the one-rank nccl run differs")
    with open(os.path.join(out_dir, "nccl.json"), "w") as f:
        json.dump({"launches": grp[3]}, f)


def run_dp_paths(cfg, dev, here: str, job: dict) -> dict:
    """Spawn the ``DP_WORLD`` gloo ranks of ``dp_rank`` on the card (the
    parent holds no tensor on it), then the one nccl rank of
    ``dp_nccl_rank``; a rank's failure fails the run.  Returns each path's
    launch counts summed over its ranks."""
    from repro_torch.dist import sharding

    import gc

    out_dir = os.path.join(here, "_smoke", "dp")
    gc.collect()  # the paths' states, some held in reference cycles
    torch.cuda.empty_cache()
    print(f"[train_dp] {DP_WORLD} ranks on {torch.cuda.get_device_name(0)} "
          f"over gloo: [train] (n={N} c={C} s={S}), [comm_dp] "
          f"{[t[0] for t in COMM_DP]}, [faults_dp] (n={NF} c={CF} "
          f"s={SF}); the parent holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    with smi_peak() as mem:
        sharding.spawn(dp_rank, DP_WORLD, backend="gloo", device="cuda",
                       init_method=sharding.file_init_method(out_dir),
                       args=(cfg, job, out_dir))
    job.pop("faults")
    torch.cuda.ipc_collect()  # the x_bar the ranks mapped
    secs = time.perf_counter() - t0
    res = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    out = {}
    for tag in ("train_dp", "comm_dp", "faults_dp"):
        out[tag] = {k: sum(x["launches"][tag][k] for x in res)
                    for k in res[0]["launches"][tag]}
        peaks = [x["peak"][tag] / 2**30 for x in res]
        print(f"[{tag}] peak per rank {[round(p, 2) for p in peaks]} GiB; "
              f"launches summed over the ranks "
              f"{ {k: v for k, v in out[tag].items() if v} }")
    print(f"[train_dp] the three gloo paths in {secs:.1f} s (spawn, "
          f"imports and builds included); the card's memory in use peaked "
          f"at {mem.peak} MiB (nvidia-smi, both ranks and this process)")
    t0 = time.perf_counter()
    sharding.spawn(dp_nccl_rank, 1, backend="nccl", device="cuda",
                   init_method=sharding.file_init_method(out_dir, "nccl"),
                   args=(out_dir,))
    with open(os.path.join(out_dir, "nccl.json")) as f:
        out["dp_nccl"] = json.load(f)["launches"]
    print(f"[dp_nccl] {time.perf_counter() - t0:.1f} s")
    import shutil

    shutil.rmtree(out_dir)
    return out


# --------------------------------------------------------------------------
# model parallelism (ROADMAP A9b): [comm_tp], [train_tp], [train_dp_tp]
# --------------------------------------------------------------------------


def release_mapped(job: dict, *names) -> None:
    """Drop a rank's references to the parent's tensors it mapped (``job``'s
    entries ``names`` and what they hold) and collect them, so that the
    parent, which holds them for the rank until the rank lets go
    (``torch.cuda.ipc_collect``), can free them once the rank exits."""
    import gc

    for name in names:
        job.pop(name, None)
    gc.collect()
    torch.cuda.synchronize()


def tp_mesh_like(mp: int, m: int):
    """A ``sharding.Mesh2D`` that only names model rank ``m`` of ``mp``
    (no groups): what ``state_spec``/``block_coords`` read."""
    from repro_torch.dist import sharding

    return sharding.Mesh2D(1, mp, m, None, None)


def to_blocks(ws: torch.Tensor, cfg, tcfg, mp: int, m: int) -> torch.Tensor:
    """Model rank ``m``'s blocks (of ``mp``) of the rows of the whole
    workspace ``ws``: its rows as ``tamuna_dp.state_spec(mesh=)`` lays
    them out, a new tensor on ``ws``' device."""
    from repro_torch.dist import comm_ws, sharding, tamuna_dp

    gspec = tamuna_dp.state_spec(cfg, tcfg)
    lspec = tamuna_dp.state_spec(cfg, tcfg, tp_mesh_like(mp, m))
    ps = sharding.params_pspecs(cfg, mp)
    out = torch.empty(ws.shape[0], lspec.d_total, dtype=ws.dtype,
                      device=ws.device)
    loc = comm_ws.unpack(out, lspec)
    for nm, v in comm_ws.unpack(ws, gspec).items():
        loc[nm].copy_(v[(slice(None),) + sharding.block_slices(
            v.shape[1:], ps[nm], mp, m)])
    return out


def from_blocks(blocks, cfg, tcfg, mp: int) -> torch.Tensor:
    """The whole workspace rows from every model rank's ``to_blocks``, a
    new tensor on their device."""
    from repro_torch.dist import comm_ws, sharding, tamuna_dp

    gspec = tamuna_dp.state_spec(cfg, tcfg)
    ps = sharding.params_pspecs(cfg, mp)
    out = torch.empty(blocks[0].shape[0], gspec.d_total,
                      dtype=blocks[0].dtype, device=blocks[0].device)
    full = comm_ws.unpack(out, gspec)
    for m, blk in enumerate(blocks):
        lspec = tamuna_dp.state_spec(cfg, tcfg, tp_mesh_like(mp, m))
        for nm, v in comm_ws.unpack(blk, lspec).items():
            full[nm][(slice(None),) + sharding.block_slices(
                full[nm].shape[1:], ps[nm], mp, m)] = v
    return out


def check_wire_at_kernels(cfg, dev):
    """The coordinate-table forms of the int wire's kernels against their
    plain versions at ``[comm_tp]``'s shapes: model rank 0's blocks (of
    ``TP_MP``) of the ``auto`` wire's int8 group of 2-layer gemma2-2b, on
    ``(N, d_g)``: ``wire_quantize`` (UpCom, rows with +inf, -inf and NaN,
    and the DownCom) with the scales of ``comm_ws._group_scales``, and
    ``masked_sum_dequant`` in both forms with the scale-column table.
    Each bitwise; returns their records."""
    from repro_torch.dist import comm_ws, tamuna_dp
    from repro_torch.kernels import ref, uplink, wire_pack

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    mesh = tp_mesh_like(TP_MP, 0)
    spec = tamuna_dp.state_spec(cfg, tcfg, mesh)
    gspec = tamuna_dp.state_spec(cfg, tcfg)
    coords = tamuna_dp.block_coords(cfg, spec, mesh, dev)
    band = comm_ws.band_of_blocks(spec.dims, gspec.dims, coords, "cyclic",
                                  C, S, dev)
    plan = comm_ws.wire_plan(spec.dims, "auto", C, S, band, ids=spec.ids,
                             gdims=gspec.dims, coords=coords)
    grp = next(g for g in plan if g.kind == "int8")
    d, dg = spec.d_total, grp.leaf_lo[-1]
    nc = grp.scale_lo[-1]
    L = len(grp.leaves)
    print(f"[check] the coordinate-table forms at [comm_tp]'s int8 group: "
          f"model rank 0 of {TP_MP}, {L} blocks, {dg} of {d} columns, {nc} "
          f"global chunks; whole 256-runs {sum(grp.runs)} of {L}")
    g = torch.Generator(device=dev).manual_seed(7)
    recs = []

    # -- wire_quantize_at: UpCom on (N, d), then the DownCom -------------
    x = torch.randn(N, d, generator=g, device=dev)
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, 7::999_983] = float("nan")
    scales = comm_ws._group_scales(x, grp)
    kw = dict(coords=grp.coords, scales=scales, gdims=grp.gdims)
    codes, sc = wire_pack.pack_int(x, grp.leaves, "int8", 0x5EED, **kw)
    codes_p, sc_p = ref.wire_pack(x, grp.leaves, "int8", 0x5EED, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(codes, codes_p), max_abs_err(sc, sc_p))
    n_bad = int(sc.isnan().sum())
    if err != 0.0 or n_bad == 0:
        raise AssertionError(f"wire_quantize_at: max abs err {err}, {n_bad} "
                             "poisoned chunks")
    del codes_p, sc_p
    up_ms = cuda_ms(lambda: wire_pack.pack_int(x, grp.leaves, "int8",
                                               0x5EED, **kw), 5)
    up_plain_ms = cuda_ms(lambda: ref.wire_pack(x, grp.leaves, "int8",
                                                0x5EED, **kw), 2)
    # x read, coordinates read once, the scales read and their copy
    # written, codes written, the leaf tables read
    up_bound = bound_ms(5 * N * dg + 8 * dg + 12 * N * nc + 48 * L)
    row = x[1].clone()
    row[3::1000] = float("nan")
    dscales = comm_ws._group_scales(row[None], grp)
    dkw = dict(coords=grp.coords, scales=dscales, gdims=grp.gdims)
    got, want = row.clone(), row.clone()
    wire_pack.quantize_down(got, grp.leaves, "int8", 0x5EED, **dkw)
    ref.wire_down(want, grp.leaves, "int8", 0x5EED, **dkw)
    torch.cuda.synchronize()
    err_down = max_abs_err(got, want)
    if err_down != 0.0:
        raise AssertionError(f"wire_quantize_at DownCom: max abs err "
                             f"{err_down}")
    down_ms = cuda_ms(lambda: wire_pack.quantize_down(
        got, grp.leaves, "int8", 0x5EED, **dkw), 5)
    down_plain_ms = cuda_ms(lambda: ref.wire_down(
        want, grp.leaves, "int8", 0x5EED, **dkw), 2)
    down_bound = bound_ms(8 * dg + 8 * dg + 4 * nc + 48 * L)
    scale_ms = cuda_ms(lambda: comm_ws._group_scales(x, grp), 3)
    print(f"[check] wire_quantize_at: {n_bad} poisoned chunk scales of "
          f"{N * nc}; UpCom {up_ms:.3f} ms ({up_bound / up_ms:.1%} of its "
          f"bound {up_bound:.3f} ms), DownCom {down_ms:.3f} ms "
          f"({down_bound / down_ms:.1%} of {down_bound:.3f} ms); the "
          f"scales' chunk maxima (plain torch) {scale_ms:.3f} ms")
    recs.append({
        "name": "wire_quantize_at", "shape": [N, dg], "max_abs_err":
        max(err, err_down), "tolerance": 0.0, "ms": up_ms,
        "plain_ms": up_plain_ms, "down_ms": down_ms,
        "down_plain_ms": down_plain_ms, "bound_ms": up_bound,
        "down_bound_ms": down_bound, "scales_ms": scale_ms,
    })
    del x, codes, sc, scales, row, got, want, dscales

    # -- masked_sum_dequant with the scale-column table, both forms -------
    band_g = grp.band
    lo = grp.leaf_lo
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    for counts, n, c, s, slot_l in ((False, N, C, S, [1, -1, 0, 2]),
                                    (True, N, C, S, [1, -1, -1, 2])):
        slot = torch.tensor(slot_l, dtype=torch.int32, device=dev)
        codes = torch.randint(-127, 128, (n, dg), generator=g, device=dev,
                              dtype=torch.int8)
        scales = torch.rand(n, nc, generator=g, device=dev).mul_(0.01)
        scales[1] = float("nan")  # an idle row's chunks never leak
        if counts:
            scales[2] = float("nan")  # the dropped member
        owned = owned_entries(slot, band_g, c, s)
        kwc = dict(counts=counts, chunk_col=grp.chunk_col)
        got = uplink.masked_sum_dequant(codes, scales, lo, slot, band_g, c,
                                        s, **kwc)
        want = ref.masked_sum_dequant(codes, scales, lo_t, slot, band_g, c,
                                      s, **kwc)
        torch.cuda.synchronize()
        got = got if counts else (got,)
        want = want if counts else (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err != 0.0 or not all(bool(a.isfinite().all()) for a in got):
            raise AssertionError(f"masked_sum_dequant_at counts={counts}: "
                                 f"max abs err {err}")
        del got, want
        name = ("masked_sum_dequant_counts_at" if counts
                else "masked_sum_dequant_at")
        outs = 2 if counts else 1
        recs.append({
            "name": name, "shape": [n, dg], "max_abs_err": err,
            "tolerance": 0.0,
            "ms": cuda_ms(lambda: uplink.masked_sum_dequant(
                codes, scales, lo, slot, band_g, c, s, **kwc), 5),
            "plain_ms": cuda_ms(lambda: ref.masked_sum_dequant(
                codes, scales, lo_t, slot, band_g, c, s, **kwc), 2),
            # owned codes read, the owning rows' scales, band and the
            # scale-column table read, the outputs written, slot read
            "bound_ms": bound_ms(owned + 4 * (3 * nc + (2 + outs) * dg
                                              + n)),
        })
        print(f"[check] {name}: {recs[-1]['ms']:.3f} ms, "
              f"{recs[-1]['bound_ms'] / recs[-1]['ms']:.1%} of the bound "
              f"({recs[-1]['bound_ms']:.3f} ms)")
        del codes, scales
    del plan, grp, band, band_g
    return recs


def block_digests(ws, cfg, tcfg, zero_sign=False):
    """Each model rank's ``row_digests`` of its blocks of ``ws``."""
    out = []
    for m in range(TP_MP):
        blk = to_blocks(ws, cfg, tcfg, TP_MP, m)
        out.append(row_digests(blk, zero_sign=zero_sign))
        del blk
    return out


def comm_tp_reference(cfg, xb, hb, dev) -> dict:
    """``[comm_tp]``'s one-process kernel steps (``COMM_TP``, in turn) on
    ``[train]``'s state put together from its model blocks ``xb``/``hb``
    (``to_blocks`` of each rank), each model rank's block digests of x and
    h after each step: ``{tag: ([x digests per rank], [h digests per
    rank], seconds)}``."""
    from repro_torch.dist import tamuna_dp

    tcfg0 = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    x = from_blocks(xb, cfg, tcfg0, TP_MP)
    h = from_blocks(hb, cfg, tcfg0, TP_MP)
    out = {}
    for tag, c, s, kw, cohort_, perm, arrived in COMM_TP:
        tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **kw)
        step = tamuna_dp.make_comm_step(cfg, tcfg, N, device=dev)
        state = tamuna_dp.DistTamunaState(
            x=x, h=h, spec=tamuna_dp.state_spec(cfg, tcfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, cohort_, perm, np.asarray(COMM_DP_DOWN),
             None if arrived is None else np.asarray(arrived), True,
             COMM_DP_SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del step
        zs = tcfg.robust_() is not None
        out[tag] = (block_digests(x, cfg, tcfg, zs),
                    block_digests(h, cfg, tcfg, zs), secs)
        print(f"[comm_tp] one-process kernel step {tag}: {secs:.3f} s",
              flush=True)
    del x, h
    torch.cuda.empty_cache()
    return out


def tp_comm_rank(rank: int, dev, cfg, job: dict, out_dir: str) -> None:
    """``[comm_tp]``: model rank ``rank`` of ``TP_MP`` (one data rank)
    runs ``COMM_TP``'s steps in turn (``make_comm_step(mesh=)``: the
    one-process kernel step on the blocks) in place on its blocks of
    ``[train]``'s state (``job``'s, on the card, held by the parent and
    mapped here: no copy) and holds each against the one-process steps'
    block digests."""
    from repro_torch.dist import sharding, tamuna_dp
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    mesh = sharding.make_mesh(N, 1, TP_MP)
    x, h = job["xb"][mesh.m_index], job["hb"][mesh.m_index]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = {"secs": {}, "max_sizes": {}}
    for tag, c, s, kw, cohort_, perm, arrived in COMM_TP:
        tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **kw)
        n_max = len(mesh.tp.sizes)
        t0 = time.perf_counter()
        step = tamuna_dp.make_comm_step(cfg, tcfg, N, device=dev, mesh=mesh)
        build = time.perf_counter() - t0
        state = tamuna_dp.DistTamunaState(
            x=x, h=h, spec=tamuna_dp.state_spec(cfg, tcfg, mesh))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, cohort_, perm, np.asarray(COMM_DP_DOWN),
             None if arrived is None else np.asarray(arrived), True,
             COMM_DP_SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del step
        torch.cuda.empty_cache()  # the step's tables
        zs = tcfg.robust_() is not None
        wx, wh, ref_secs = job["comm"][tag]
        ok = (np.array_equal(row_digests(x, zero_sign=zs),
                             wx[mesh.m_index])
              and np.array_equal(row_digests(h, zero_sign=zs),
                                 wh[mesh.m_index]))
        sizes = mesh.tp.sizes[n_max:]
        res["secs"][tag] = secs
        res["max_sizes"][tag] = list(sizes)
        print(f"[comm_tp rank {rank}] {tag} (c={c} s={s}): x and h bitwise "
              f"the one-process kernel step's blocks"
              f"{' up to the sign of zero' if zs else ''} {ok}; {secs:.3f} s "
              f"(one process {ref_secs:.3f} s; tables built in {build:.2f} "
              f"s); the scales' MAX over the model group: elements {sizes}",
              flush=True)
        if not ok:
            raise AssertionError(f"[comm_tp] {tag} rank {rank} differs")
    res["launches"] = dict(_build.launch_counts)
    res["peak"] = torch.cuda.max_memory_allocated()
    print(f"[comm_tp rank {rank}] peak {res['peak'] / 2**30:.2f} GiB",
          flush=True)
    del x, h, state
    release_mapped(job, "xb", "hb")
    with open(os.path.join(out_dir, f"comm_tp{rank}.json"), "w") as f:
        json.dump(res, f)


def first_member_step(cfg, dev, tp=None, mp=1, m=0):
    """The first local step of round 0's first cohort member in
    ``[train]``'s schedule: its loss and gradients on the initial model
    (the whole model, or model rank ``m``'s blocks under ``tp``)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import model_api, rounds, sharding

    params = model_api.init(cfg, seed=0, device=dev)
    if tp is not None:
        ps = sharding.params_pspecs(cfg, mp)
        params = {k: v[sharding.block_slices(v.shape, ps[k], mp, m)].clone()
                  for k, v in params.items()}
    pd = cfg.param_dtype
    params = {k: v.to(pd).requires_grad_(True) for k, v in params.items()}
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=N), cfg, dev)
    # run_rounds' generator is seeded 1: its cohorts' seed
    cohort0 = rounds._host_cohort(None, 1, N, C)(0)
    batch = pipe.sample_batch(cohort0)
    loss, _ = model_api.loss(params, cfg, tokens=batch["tokens"][0],
                             labels=batch["labels"][0], tp=tp)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, (g.detach() for g in grads)))


def tp_step_reference(cfg, dev) -> dict:
    """What ``[train_tp]``'s first member step is held to: the one-process
    step's loss and gradients (kept on the card for the ranks) and each
    one's distance to the same step in float64 on the card."""
    loss, grads = first_member_step(cfg, dev)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64,
                                param_dtype=torch.float64)
    loss64, grads64 = first_member_step(cfg64, dev)
    dist = {k: float((grads[k].double() - grads64[k]).abs().max())
            for k in grads}
    top = {k: float(grads64[k].abs().max()) for k in grads}
    out = {"loss": float(loss), "loss_dist": abs(float(loss) - float(loss64)),
           "grads": grads, "dist": dist, "top": top}
    del grads64, loss64
    torch.cuda.empty_cache()
    print(f"[train_tp] the first member step in one process: loss "
          f"{out['loss']:.6f}, {out['loss_dist']:.3e} from float64; each "
          f"leaf's max |g - g64| / max|g64|: "
          f"{ {k: f'{dist[k] / top[k]:.2e}' for k in dist} }", flush=True)
    return out


def tp_h_sum_ratio(h: torch.Tensor, mesh) -> float:
    """|sum_i h_i| / max|h| over the whole state: each model rank's block
    columns (every data rank's rows summed first), both maxima maxed over
    the model group."""
    g = mesh.rows
    hsum = 0.0
    for a in range(0, h.shape[1], 1 << 27):
        col = h[:, a:a + (1 << 27)].sum(0)
        if g.world > 1:
            g.all_reduce(col)
        hsum = max(hsum, float(col.abs().max()))
    t = torch.tensor([hsum, float(h.abs().max())], device=h.device)
    if g.world > 1:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.pg)
    mesh.tp.all_reduce(t, "max")
    return float(t[0] / t[1]) if float(t[1]) > 0 else math.inf


def tp_train_rank(rank: int, dev, cfg, dp: int, job: dict,
                  out_dir: str) -> None:
    """``[train_tp]`` (``dp = 1``) or ``[train_dp_tp]`` (``dp = TP_DP``):
    rank ``rank`` of the ``dp x TP_MP`` mesh trains ``[train]``'s
    schedule on its rows and blocks (``run_rounds(group=mesh)``), one
    round per call.  ``[train_tp]`` first holds the first member step
    against the one process's (``job["step"]``), then checks its rounds'
    L and finite losses and sum_i h_i = 0, and writes its digests after
    2 rounds; ``[train_dp_tp]`` holds its rows' digests and losses after
    2 rounds to ``[train_tp]``'s bitwise."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import rounds, sharding, tamuna_dp
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    tag = "train_tp" if dp == 1 else "train_dp_tp"
    mesh = sharding.make_mesh(N, dp, TP_MP)
    m = mesh.m_index
    res = {}
    if dp == 1:
        ref = job["step"]
        loss, grads = first_member_step(cfg, dev, mesh.tp, TP_MP, m)
        ps = sharding.params_pspecs(cfg, TP_MP)
        errs = torch.tensor([
            float((g.float() - ref["grads"][k][sharding.block_slices(
                ref["grads"][k].shape, ps[k], TP_MP, m)].float()
                  ).abs().max()) for k, g in grads.items()], device=dev)
        mesh.tp.all_reduce(errs, "max")
        l_err = abs(float(loss) - ref["loss"])
        ratios = {k: float(e) / ref["dist"][k] for k, e in zip(grads, errs)}
        ok = l_err <= TP_STEP_FACTOR * ref["loss_dist"] and all(
            r <= TP_STEP_FACTOR for r in ratios.values())
        print(f"[train_tp rank {rank}] the first member step, tensor "
              f"parallel: loss {float(loss):.6f}, {l_err:.3e} from the one "
              f"process (limit {TP_STEP_FACTOR} x its {ref['loss_dist']:.3e}"
              f" from float64); each leaf's max |g_tp - g| / the one "
              f"process's max |g - g64|: "
              f"{ {k: round(r, 4) for k, r in ratios.items()} } (limit "
              f"{TP_STEP_FACTOR}) {ok}", flush=True)
        if not ok:
            raise AssertionError(f"[train_tp] rank {rank}: the first member "
                                 "step is past its limits")
        res["step_ratio"] = max(ratios.values())
        del grads, loss, ref
        release_mapped(job, "step")
        torch.cuda.empty_cache()
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    t0 = time.perf_counter()
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev,
                                 mesh=mesh)
    init_s = time.perf_counter() - t0
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=N), cfg, dev)
    common = dict(cfg=cfg, tcfg=tcfg, pipe=pipe,
                  rng=np.random.default_rng(0),
                  generator=torch.Generator().manual_seed(1), max_L=4,
                  flush_every=1, group=mesh)
    n_rounds = 3 if dp == 1 else 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    rows = []
    for r in range(n_rounds):
        k_tp, k_dp = len(mesh.tp.seconds), len(mesh.rows.seconds)
        with round_events() as evs:
            evs.start()
            state, more = rounds.run_rounds(state, rounds=1, **common)
        row = more[0]
        row["local_steps"] += rows[-1]["local_steps"] if rows else 0
        row["device_s"] = evs.seconds()[0]
        row["tp_s"] = sum(mesh.tp.seconds[k_tp:])
        row["tp_n"] = len(mesh.tp.seconds) - k_tp
        row["dp_s"] = sum(mesh.rows.seconds[k_dp:])
        row["dp_sizes"] = mesh.rows.sizes[k_dp:]
        rows.append(row)
        print(f"[{tag} rank {rank}] round {row['round']}: L={row['L']} loss "
              f"{row['loss']:.6f} host {row['seconds']:.3f} s device "
              f"{row['device_s'] * 1e3:.1f} ms; the model group's "
              f"{row['tp_n']} activation sums {row['tp_s']:.3f} s; the data "
              f"group's sums {row['dp_s']:.3f} s over {row['dp_sizes']} "
              f"elements", flush=True)
        if r == 1:
            res["x2"] = row_digests(state.x).tolist()
            res["h2"] = row_digests(state.h).tolist()
            res["loss2"] = [rw["loss"] for rw in rows]
    res["launches"] = dict(_build.launch_counts)
    res["peak"] = torch.cuda.max_memory_allocated()
    res["L"] = [rw["L"] for rw in rows]
    res["loss"] = [rw["loss"] for rw in rows]
    res["dp_max"] = max([max(rw["dp_sizes"], default=0) for rw in rows])
    d_local = state.x.shape[1]
    ratio = tp_h_sum_ratio(state.h, mesh)
    finite = all(math.isfinite(v) for v in res["loss"])
    print(f"[{tag} rank {rank}] rows {mesh.rows.row0}..{mesh.rows.stop - 1} "
          f"of {N}, model block {m} of {TP_MP} ({d_local} columns, d_total "
          f"/ mp = {tamuna_dp.state_spec(cfg, tcfg).d_total / TP_MP:.0f}); "
          f"init {init_s:.1f} s; losses finite {finite}; |sum_i h_i| / "
          f"max|h| over the state {ratio:.3e} (limit 1e-4); peak "
          f"{res['peak'] / 2**30:.2f} GiB; largest data-group collective "
          f"{res['dp_max']} elements (d_total / mp {d_local}); launches "
          f"{ {k: v for k, v in res['launches'].items() if v} }", flush=True)
    if not finite or ratio > 1e-4 or res["dp_max"] > d_local:
        raise AssertionError(f"[{tag}] rank {rank}: losses finite {finite}, "
                             f"h sum ratio {ratio}")
    if dp == 1:
        want = job["train"]
        ok = res["L"] == want["L"]
        rel = [abs(a - b) / abs(b) for a, b in zip(res["loss"], want["loss"])]
        print(f"[train_tp rank {rank}] L per round {res['L']} equal "
              f"[train]'s {ok}; losses relative to [train]'s "
              f"{[f'{v:.3e}' for v in rel]} (not gated: the steps carry the "
              f"first step's reassociation)", flush=True)
        if not ok:
            raise AssertionError("[train_tp] L differs from [train]'s")
    else:
        want = job["tp"][m]
        rows_ = slice(mesh.rows.row0, mesh.rows.stop)
        same = (np.array_equal(np.asarray(res["x2"]),
                               np.asarray(want["x2"])[rows_])
                and np.array_equal(np.asarray(res["h2"]),
                                   np.asarray(want["h2"])[rows_]))
        lsame = res["loss2"] == want["loss2"]
        print(f"[train_dp_tp rank {rank}] after 2 rounds x and h bitwise "
              f"[train_tp]'s rows {mesh.rows.row0}..{mesh.rows.stop - 1} of "
              f"block {m} {same}; losses {res['loss2']} equal {lsame}",
              flush=True)
        if not (same and lsame):
            raise AssertionError(f"[train_dp_tp] rank {rank} differs from "
                                 "[train_tp]")
    del state, pipe
    with open(os.path.join(out_dir, f"{tag}{rank}.json"), "w") as f:
        json.dump(res, f)


def spawn_tp(tag, fn, world, here, args) -> tuple:
    """Spawn ``world`` gloo ranks of ``fn`` on the card (fresh processes
    that exit before this returns), the card's memory sampled with
    ``nvidia-smi``; returns ``(the ranks' result files, seconds, peak
    MiB)``."""
    from repro_torch.dist import sharding

    import gc

    out_dir = os.path.join(here, "_smoke", "tp")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with smi_peak() as mem:
        sharding.spawn(fn, world, backend="gloo", device="cuda",
                       init_method=sharding.file_init_method(out_dir, tag),
                       args=(*args, out_dir))
    # the tensors the ranks mapped stay held for them until collected
    torch.cuda.ipc_collect()
    secs = time.perf_counter() - t0
    print(f"[{tag}] after the ranks this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{tag}{r}.json")) as f:
            res.append(json.load(f))
    peaks = [x["peak"] / 2**30 for x in res]
    print(f"[{tag}] {world} ranks in {secs:.1f} s (spawn, imports and the "
          f"state's set-up included); peak per rank "
          f"{[round(p, 2) for p in peaks]} GiB; the card's memory in use "
          f"peaked at {mem.peak} MiB (nvidia-smi, every rank and this "
          f"process)", flush=True)
    return res, secs, mem.peak


def summed_launches(res) -> dict:
    return {k: sum(x["launches"][k] for x in res) for k in res[0]["launches"]}


def run_comm_tp(cfg, dev, here, xb, hb, job) -> dict:
    """``[comm_tp]``: ``TP_MP`` ranks on the card map their blocks
    ``xb[m]``/``hb[m]`` of ``[train]``'s state (held by this process) and
    run ``COMM_TP`` on them in place; returns the launch counts summed
    over the ranks."""
    print(f"[comm_tp] {TP_MP} model ranks on {torch.cuda.get_device_name(0)} "
          f"over gloo, one data rank: {[t[0] for t in COMM_TP]} on "
          f"[train]'s state; the parent holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    res, _, _ = spawn_tp("comm_tp", tp_comm_rank, TP_MP, here,
                         (cfg, dict(job, xb=xb, hb=hb)))
    out = summed_launches(res)
    print(f"[comm_tp] launches summed over the ranks "
          f"{ {k: v for k, v in out.items() if v} }", flush=True)
    return out


def run_tp_paths(cfg, dev, here, job) -> dict:
    """``[train_tp]`` (``TP_MP`` ranks) then ``[train_dp_tp]`` (``TP_DP x
    TP_MP``), each in fresh ranks; the first member step's one-process
    reference is made here first.  Returns each path's launch counts
    summed over its ranks."""
    import shutil

    job = dict(job, step=tp_step_reference(cfg, dev))
    print(f"[train_tp] {TP_MP} model ranks over gloo on the card: [train]'s "
          f"schedule (n={N} c={C} s={S}), 3 rounds", flush=True)
    res, _, _ = spawn_tp("train_tp", tp_train_rank, TP_MP, here,
                         (cfg, 1, job))
    out = {"train_tp": summed_launches(res)}
    del job["step"]
    torch.cuda.ipc_collect()  # the one-process gradients the ranks mapped
    torch.cuda.empty_cache()
    print(f"[train_tp] this process now holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"[train_dp_tp] {TP_DP} x {TP_MP} ranks over gloo on the card: "
          f"[train_tp]'s first 2 rounds", flush=True)
    res2, _, _ = spawn_tp("train_dp_tp", tp_train_rank, TP_DP * TP_MP, here,
                          (cfg, TP_DP, dict(job, tp=res)))
    out["train_dp_tp"] = summed_launches(res2)
    for tag in out:
        print(f"[{tag}] launches summed over the ranks "
              f"{ {k: v for k, v in out[tag].items() if v} }", flush=True)
    shutil.rmtree(os.path.join(here, "_smoke", "tp"), ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import (cohort, comm_ws, faults, model_api,
                                  tamuna_dp, wire)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = smi()
    print(f"[card] {card}")

    path, secs, log = _build.build()
    print(f"[build] {os.path.relpath(path, here)} in {secs:.1f} s")
    for line in log.splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            print(f"[build] {line.strip()}")
    spills = [line for line in log.splitlines() if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    print(f"[build] {len(spills)} kernel instantiations spill registers")
    _build.load()

    cfg = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
    print(f"[config] {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}); depth cut "
          f"{gemma2_2b.CONFIG.n_layers} -> {cfg.n_layers} layers, windows "
          f"{cfg.layer_windows()}")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    print(f"[config] d_total {spec.d_total} f32 per client row")

    recs, by_path = [], {}
    recs += check_uplink_kernels(spec, tcfg, dev)
    torch.cuda.empty_cache()
    recs.append(check_local_step(spec, dev))
    torch.cuda.empty_cache()
    recs += check_fault_kernels(spec, dev)
    torch.cuda.empty_cache()
    recs += check_wire_kernels(spec, dev)
    torch.cuda.empty_cache()
    recs += check_wire_at_kernels(cfg, dev)
    torch.cuda.empty_cache()
    recs += check_compress_kernels(spec.d_total, dev)
    torch.cuda.empty_cache()
    recs += check_domain_kernels(dev)
    torch.cuda.empty_cache()
    for rec in recs:
        print(f"[check] {rec['name']} {rec['shape']}: max abs err "
              f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
              f"{rec['ms']:.3f} ms vs plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of it)")
    # the CPU side on one intra-op thread: its multithreaded products
    # are not repeatable from run to run, the card's are
    with intra_op_threads(REDUCED_CPU_THREADS):
        check_reduced_round(dev, N, C, S, [0, 2, 3], [2, 0, 1],
                            [True, True, False, True])
        # the faulted round: member 1 dropped, the trimmed mean
        check_reduced_round(dev, NF, CF, SF, [0, 1, 3, 4],
                            [3, 0, 2, 1], [True, True, True, False, True],
                            arrived=[True, False, False, True, True],
                            robust_agg="trimmed", trim_k=1)
        check_reduced_wire_round(dev)
        # the blocked template: fault-free, a drop with the trimmed mean,
        # and int8 wire_down with a drop (its comm step bitwise)
        check_reduced_round(dev, N, C, S, [0, 2, 3], 1,
                            [True, True, False, True], uplink="block_rs")
        check_reduced_round(dev, NF, CF, SF, [0, 1, 3, 4], 2,
                            [True, True, True, False, True],
                            arrived=[True, False, False, True, True],
                            uplink="block_rs", robust_agg="trimmed",
                            trim_k=1)
        check_reduced_wire_round(dev, uplink="block_rs")
        check_reduced_adamw_round(dev)
        check_tall_round(dev)
        # the other families' reduced configs
        t0 = time.perf_counter()
        for arch in FAMILY_ARCHS:
            check_reduced_family_round(dev, arch)
        print(f"[reduced] family rounds {time.perf_counter() - t0:.1f} s")
        # past the flash threshold: the blockwise attention under remat
        t0 = time.perf_counter()
        # one local step, the float64 anchor on every core
        check_reduced_family_round(dev, "gemma2-2b", seq=REDUCED_LONG_SEQ,
                                   batch=1, steps=1,
                                   f64_threads=os.cpu_count())
        print(f"[reduced] {REDUCED_LONG_SEQ}-token round "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- the paths: 3 rounds of full-width 2-layer gemma2-2b each --------
    by_path["train"], state, rows = run_path(
        "train", cfg, tcfg, N, dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=True, keep=True)
    # what the data-parallel paths are held to: [train]'s rows, and
    # [comm_dp]'s one-process kernel steps in turn from [train]'s state
    dp_job = {"train": {"x": row_digests(state.x),
                        "h": row_digests(state.h),
                        "loss": [r["loss"] for r in rows]}}
    # what the model-parallel paths are held to: [train]'s rows, and
    # [comm_tp]'s one-process kernel steps in turn from [train]'s state
    tp_job = {"train": {"L": [r["L"] for r in rows],
                        "loss": [r["loss"] for r in rows]}}
    # [comm_tp]'s ranks work in place on their blocks of [train]'s state,
    # cut here, so the card holds the state once while they run
    xb = [to_blocks(state.x, cfg, tcfg, TP_MP, m) for m in range(TP_MP)]
    hb = [to_blocks(state.h, cfg, tcfg, TP_MP, m) for m in range(TP_MP)]
    dp_job["comm"] = comm_dp_steps(cfg, state.x, state.h, dev)
    for tag, (_, _, secs, _) in dp_job["comm"].items():
        print(f"[comm_dp] one-process kernel step {tag}: {secs:.3f} s")
    del state, rows
    torch.cuda.empty_cache()
    tp_job["comm"] = comm_tp_reference(cfg, xb, hb, dev)
    by_path["comm_tp"] = run_comm_tp(cfg, dev, here, xb, hb, tp_job)
    del xb, hb
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    sync = run_sync_check(cfg, dev)
    by_path["train_long"] = run_train_long(dev)
    torch.cuda.empty_cache()
    memory = run_memory_table(dev, here)
    tcfg_f = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P)
    plan_f = cohort.CohortPlan(0, NF, CF)
    by_path["faults"], state, rows = run_path(
        "faults", cfg, tcfg_f, NF, dev,
        need=("masked_sum_counts", "h_update_covered", "fused_local_step"),
        check_h_sum=True, keep=True,
        plan=plan_f,
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.25, p_corrupt=0.2,
                                corrupt_mode="nan"),
        policy="quorum", quarantine_rounds=2)
    dp_job["faults"] = faults_dp_reference(cfg, dev, rows, plan_f)
    del state, rows
    by_path.update(run_dp_paths(cfg, dev, here, dp_job))
    del dp_job
    by_path.update(run_tp_paths(cfg, dev, here, tp_job))
    del tp_job
    # a robust combine breaks sum_i h_i = 0 by design: not checked
    tcfg_r = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P,
                                        robust_agg="trimmed", trim_k=1)
    by_path["robust"] = run_path(
        "robust", cfg, tcfg_r, NF, dev,
        need=("robust_sum", "h_update_covered", "fused_local_step"),
        check_h_sum=False,
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.2,
                                adversary="sign_flip", f_byz=0.2),
        policy="quorum")
    by_path["reputation"] = run_reputation(cfg, dev)
    tcfg_w = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P,
                                        wire_precision="auto",
                                        wire_down=True)
    kinds = [wire.resolve_kind(D, "auto") for D in spec.dims]
    print(f"[wire] auto wire kinds: {kinds.count('f16')} f16 leaves "
          f"({sum(D for D, k in zip(spec.dims, kinds) if k == 'f16')} "
          f"coordinates), {kinds.count('int8')} int8 leaves; per-client "
          f"UpCom bytes per round: f32 {up_bytes(spec, C, S, 'f32'):.0f}, "
          f"auto {up_bytes(spec, C, S, 'auto'):.0f}, int8 "
          f"{up_bytes(spec, C, S, 'int8'):.0f} (int8 over f32: "
          f"{up_bytes(spec, C, S, 'f32') / up_bytes(spec, C, S, 'int8'):.4f}"
          f"x)")
    by_path["wire"] = run_path(
        "wire", cfg, tcfg_w, N, dev,
        need=("masked_sum_dequant", "masked_sum_f16", "wire_quantize",
              "h_update", "fused_local_step"),
        check_h_sum=False)
    tcfg_wf = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P,
                                         wire_precision="int8")
    by_path["wire_faults"] = run_path(
        "wire_faults", cfg, tcfg_wf, NF, dev,
        need=("masked_sum_dequant_counts", "wire_quantize",
              "h_update_covered", "fused_local_step"),
        check_h_sum=False,
        plan=cohort.CohortPlan(0, NF, CF),
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.25),
        policy="quorum")
    by_path.update(run_family_paths(dev))
    by_path.update(run_new_family_paths(dev))
    by_path["train_whisper"] = run_whisper_path(dev)
    by_path.update(run_train_options(cfg, dev))
    by_path["checkpoint"] = run_checkpoint(
        dev, os.path.join(here, "_smoke"))

    # ---- the pipelined rounds (tau 0 and 1) ------------------------------
    t0 = time.perf_counter()
    by_path.update(run_pipeline(cfg, dev, here))
    print(f"[pipeline] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with intra_op_threads(REDUCED_CPU_THREADS):
        check_reduced_pipelined(dev)
    print(f"[reduced] pipelined phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["pipeline_ckpt"] = run_pipeline_ckpt(
        dev, os.path.join(here, "_smoke"))
    print(f"[pipeline_ckpt] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["pipeline_bench"] = run_pipeline_bench(dev, here)
    print(f"[pipeline_bench] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- the convex core at paper scale: Fig. 3's problem, c=100, 1000 --
    from repro_torch.core import problems, tamuna

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob = problems.make_logreg_problem(**CONVEX, name="realsim-like",
                                        device=dev)
    setup = prob.meta["setup_s"]
    print(f"[convex] problem {prob.name} {CONVEX}: set-up "
          f"{time.perf_counter() - t0:.3f} s (data {setup['data']:.3f} s, "
          f"L {setup['L']:.3f} s, Newton {setup['newton']:.3f} s in "
          f"{prob.meta['newton_iters']} steps); mu {prob.mu:.10e} L "
          f"{prob.L:.10e} f* {prob.f_star:.15e} |grad f(x*)| "
          f"{float(prob.grad(prob.x_star).norm()):.3e}; shared by both "
          f"convex paths")
    check_convex_card_vs_cpu(prob, tamuna.TamunaConfig.tuned(prob, c=100))
    torch.cuda.empty_cache()
    by_path["convex"], tr_pp10 = run_convex_path(
        "convex", prob, 100, CONVEX_ROUNDS["convex"])
    by_path["convex_full"], tr_full = run_convex_path(
        "convex_full", prob, 1000, CONVEX_ROUNDS["convex_full"])
    by_path["convex_comm"] = run_convex_comm(prob, dev)
    by_path["baselines"] = run_baselines(
        prob, {"full": tr_full, "pp10": tr_pp10})
    del prob, tr_full, tr_pp10
    torch.cuda.empty_cache()
    by_path["convex_bench"] = run_convex_bench(dev)

    recs += check_decode_kernels(dev)
    torch.cuda.empty_cache()
    recs += check_decode_hd80(dev)
    torch.cuda.empty_cache()
    recs += check_decode_hd128(dev)
    torch.cuda.empty_cache()
    by_path.update(run_serve_paths(dev))
    by_path["examples"] = run_examples()

    src = "src/repro_torch/kernels/csrc/tamuna_kernels.cu"
    # each kernel's body in the reference and the path whose launches the
    # record reports
    replaces = {
        "masked_sum": ("src/repro/kernels/uplink.py:55", "train"),
        "masked_sum_counts": ("src/repro/kernels/uplink.py:65", "faults"),
        "robust_sum": ("src/repro/kernels/uplink.py:106", "robust"),
        "h_update": ("src/repro/kernels/uplink.py:153", "train"),
        "h_update_covered": ("src/repro/kernels/uplink.py:167", "faults"),
        # the rest of the Pallas kernels' domain: no path runs s > 16 or
        # more than 4096 clients
        "robust_sum_large_s": ("src/repro/kernels/uplink.py:106", None),
        "h_update_large_n": ("src/repro/kernels/uplink.py:153", None),
        "h_update_covered_large_n": ("src/repro/kernels/uplink.py:167",
                                     None),
        "fused_local_step": ("src/repro/kernels/local_step.py:26", "train"),
        "masked_sum_dequant": ("src/repro/kernels/uplink.py:80", "wire"),
        "masked_sum_dequant_counts": ("src/repro/kernels/uplink.py:94",
                                      "wire_faults"),
        "masked_sum_f16": ("src/repro/kernels/uplink.py:55", "wire"),
        # no path sends bf16 lanes (--wire-precision bf16 does)
        "masked_sum_bf16": ("src/repro/kernels/uplink.py:55", None),
        "wire_quantize": ("src/repro/dist/wire.py:245 quantize_to_int, "
                          "src/repro/dist/wire.py:221 quantize", "wire"),
        # the coordinate-table forms: model-sharded blocks
        "wire_quantize_at": ("src/repro/dist/wire.py:245 quantize_to_int, "
                             "src/repro/dist/wire.py:221 quantize", "comm_tp"),
        "masked_sum_dequant_at": ("src/repro/kernels/uplink.py:80",
                                  "comm_tp"),
        "masked_sum_dequant_counts_at": ("src/repro/kernels/uplink.py:94",
                                         "comm_tp"),
        "compress_f64": ("src/repro/kernels/compress.py:71", "convex"),
        # no path of either package compresses f32 or one vector
        "compress_f32": ("src/repro/kernels/compress.py:71", None),
        "compress_1d_f64": ("src/repro/kernels/compress.py:63", None),
        "compress_1d_f32": ("src/repro/kernels/compress.py:63", None),
        "decode_attention": ("src/repro/kernels/decode_attn.py:33", "serve"),
        "decode_attention_f32": ("src/repro/kernels/decode_attn.py:33",
                                 "serve_reduced"),
        "decode_attention_f32_bf16kv": (
            "src/repro/kernels/decode_attn.py:33", "serve_reduced"),
        # head_dim 80: only [serve_stablelm] serves it (bf16); no path
        # serves an hd-80 model in f32
        "decode_attention_hd80": ("src/repro/kernels/decode_attn.py:33",
                                  "serve_stablelm"),
        "decode_attention_f32_hd80": ("src/repro/kernels/decode_attn.py:33",
                                      None),
        "decode_attention_f32_bf16kv_hd80": (
            "src/repro/kernels/decode_attn.py:33", None),
        # head_dim 128: [serve_moe] (group 1; [serve_qwen3] group 8)
        "decode_attention_hd128": ("src/repro/kernels/decode_attn.py:33",
                                   "serve_moe"),
    }
    kernels = []
    for rec in recs:
        body, path_name = replaces[rec["name"]]
        count = rec.get("count", rec["name"])
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": body,
            "launches": (0 if path_name is None
                         else by_path[path_name][count]),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec.get("bound_by", "bytes"),
            "library_ms": rec.get("library_ms"),
            "shape": rec["shape"], "tolerance": rec["tolerance"],
            "path": path_name,
            "launches_by_path": {p: by_path[p][count] for p in by_path},
            **{k: v for k, v in rec.items() if k not in (
                "name", "shape", "max_abs_err", "tolerance", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    print(f"[sync] synchronising calls between drains: "
          f"{sync['between_drains']} {sync['sites']}")
    print(f"[memory] summary {json.dumps(memory)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
